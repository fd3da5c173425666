"""Continuous batching for decoder serving (llama.cpp "slots" equivalent).

The counterpart of ``persian_rag_tpu.gen.continuous``. The static
micro-batcher (gen/local_server.py) decodes a request group to completion
before admitting new arrivals, so a long answer blocks the whole batch.
This module keeps a fixed-size decode batch RESIDENT on the card and swaps
finished rows for queued prompts mid-flight, as the llama.cpp server's slot
scheduler does:

- decode runs in SEGMENTS of up to ``segment`` forwards that advance every
  active row;
- a new request is ADMITTED between segments: a prefill of its
  length-bucketed prompt fills the row's KV and samples its first token,
  with no host readback on the admission path;
- every per-row quantity (prompt length, generation-region start, tokens
  generated, budget, temperature, top_p, penalties and their look-back
  window, the committed tokens) is a (B,) or (B, ...) device tensor, so
  rows at different phases of different requests share each
  weight-stream-bound decode forward.

Cache layout per row: prompt KV occupies slots [0, plen); the generation
region starts at the row's padded bucket ``bstart`` (pad slots [plen,
bstart) keep prefill garbage and stay masked forever); RoPE positions
remain the true token positions. Done rows park their write slot at
``max_len``, which the decoder drops. Greedy outputs equal
``TextGenerator.generate_ids_device`` token for token.

Where this differs from the JAX package (ROADMAP section 3):

- a segment is a host loop of eager forwards (the JAX package compiles one
  ``lax.while_loop``); the host reads one small tensor per forward, whether
  every row is done, and the segment's tokens once at its end;
- sampled rows draw from a seeded ``torch.Generator``: greedy streams equal
  the JAX package's, sampled streams cannot;
- admission prefills straight into the free row of the resident cache (in
  place) instead of into a (1, max_len) cache that is then copied over the
  row. The slots the prefill leaves stale are outside every mask the row
  is read through, where a stale value weighs exactly zero;
- ``speculative="auto"`` normalises acceptance by the rows active at each
  verify forward. The JAX batcher multiplies a segment's forwards by the
  rows active at its start, so rows that finish early inside a segment
  inflate its normaliser and demote workloads whose true acceptance clears
  ``SPEC_AUTO_TPF_FLOOR``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from persian_rag_tpu_torch.gen.generator import (
    PENALTY_LAST_N,
    TextGenerator,
    _penalize,
    _recent_window,
    _sampling_filter,
)

_NEUTRAL_PEN = (1.0, 0.0, 0.0)


def _rows(cache, row: int):
    """Views of one batch row of a cache (a dict / list tree of (B, ...)
    tensors, one tree per attention shard on a mesh)."""
    if isinstance(cache, dict):
        return {k: _rows(v, row) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_rows(v, row) for v in cache]
    return cache[row:row + 1]


@dataclass
class Request:
    """One generation request tracked by the batcher."""

    req_id: int
    prompt_ids: List[int]
    max_tokens: int
    temperature: float
    top_p: float
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    tokens: List[int] = field(default_factory=list)
    done: bool = False

    @property
    def penalties(self):
        return (self.repeat_penalty, self.frequency_penalty,
                self.presence_penalty)


class ContinuousBatcher:
    """Fixed-batch continuous decode scheduler over a TextGenerator.

    Single-threaded by design: callers ``submit()`` requests and drive
    ``step()`` (admit + one decode segment) until ``finished()`` drains
    completed requests. The HTTP server wraps this in its worker thread
    (gen/local_server.py); tests and chip_smoke.py drive it directly.

    ``top_k`` is one value for the batcher (llama.cpp's default 40 is the
    serving contract); temperature, top_p and the penalties are per request.

    ``speculative=True`` turns each forward of a segment into a
    prompt-lookup draft of ``draft_len`` tokens per row plus one verify
    forward of (B, draft_len + 1) tokens: greedy rows commit up to
    ``draft_len + 1`` tokens per forward, token-identical to plain greedy;
    sampled and penalised rows ride along committing one token per forward
    off the block's first logits. ``speculative="auto"`` starts speculative
    and demotes itself, for good, to the plain scheduler at an empty-batch
    boundary once aggregate tokens per active-row forward fall below
    ``SPEC_AUTO_TPF_FLOOR`` after ``SPEC_AUTO_MIN_FORWARDS`` verify
    forwards.
    """

    # a plain step commits 1 token per active row; a (G+1)-wide verify
    # forward costs about as much, so 1.3 tokens per active-row forward is
    # about break-even (the JAX package's thresholds)
    SPEC_AUTO_MIN_FORWARDS = 64
    SPEC_AUTO_TPF_FLOOR = 1.3

    def __init__(
        self,
        generator: TextGenerator,
        batch: int = 8,
        segment: int = 32,
        top_k: int = 40,
        length_bucket: int = 32,
        seed: int = 0,
        speculative=False,
        draft_len: int = 5,
        ngram: int = 3,
    ):
        self.gen = generator
        self.config = generator.config
        self.model = generator.model
        self.max_len = generator.max_len
        self.device = generator.device
        self.batch = batch
        self.segment = segment
        self.top_k = top_k
        self.length_bucket = length_bucket
        self.eos = getattr(generator.tokenizer, "eos_id", -1)
        self.pad_id = getattr(generator.tokenizer, "pad_id", 0)
        self._spec_auto = speculative == "auto"
        self.speculative = bool(speculative)
        self.spec_demoted = False
        self.draft_len = draft_len
        self.ngram = ngram
        self._next_id = 0
        self._pending: List[Request] = []
        self._rows: List[Optional[Request]] = [None] * batch
        self._finished: List[Request] = []
        # per-row count of tokens already handed to the request (host
        # knowledge; the speculative readout window starts here)
        self._flushed = np.zeros((batch,), np.int64)
        # emitted tokens, verify forwards, and active rows summed over the
        # verify forwards (the per-row normaliser of the "auto" policy)
        self.spec_stats = {"tokens": 0, "forwards": 0, "row_forwards": 0}
        self._rng = torch.Generator(device=self.device).manual_seed(seed)

        dev = self.device
        ints = dict(dtype=torch.long, device=dev)
        self.state = {
            "cache": generator.new_cache(batch, self.max_len),
            "token": torch.zeros((batch,), **ints),
            # slot-aligned committed tokens (prompt + generation), where the
            # speculative drafts look up n-grams; draft_len + 1 spare columns
            # take the verify writes of parked (done) rows
            "seq": torch.zeros((batch, self.max_len + draft_len + 1), **ints),
            "plen": torch.ones((batch,), **ints),
            "bstart": torch.zeros((batch,), **ints),
            "ngen": torch.zeros((batch,), **ints),
            "nmax": torch.zeros((batch,), **ints),
            "done": torch.ones((batch,), dtype=torch.bool, device=dev),
            "temp": torch.zeros((batch,), dtype=torch.float32, device=dev),
            "topp": torch.ones((batch,), dtype=torch.float32, device=dev),
            # llama.cpp penalty chain per row: (repeat, frequency, presence)
            # and the last PENALTY_LAST_N context tokens it looks back over
            "pen": torch.tensor(_NEUTRAL_PEN, device=dev).repeat(batch, 1),
            "recent": torch.full((batch, PENALTY_LAST_N),
                                 self.config.vocab_size, **ints),
        }

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt_ids: Sequence[int],
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        repeat_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
    ) -> int:
        req = Request(
            self._next_id, list(prompt_ids), int(max_tokens),
            float(temperature), float(top_p), float(repeat_penalty),
            float(frequency_penalty), float(presence_penalty),
        )
        self._next_id += 1
        self._pending.append(req)
        return req.req_id

    def idle(self) -> bool:
        return not self._pending and all(r is None for r in self._rows)

    @torch.no_grad()
    def step(self) -> None:
        """Admit queued requests into free rows, then run one segment."""
        if (
            self._spec_auto
            and self.speculative
            and all(r is None for r in self._rows)  # empty-batch boundary
            and self.spec_stats["forwards"] >= self.SPEC_AUTO_MIN_FORWARDS
            and self.spec_stats["tokens"]
            < self.SPEC_AUTO_TPF_FLOOR * self.spec_stats["row_forwards"]
        ):
            # sticky demotion; every per-row state resets at admission
            self.speculative = False
            self.spec_demoted = True
        for row in range(self.batch):
            if self._rows[row] is None and self._pending:
                self._admit(row, self._pending.pop(0))
        live = [r for r in self._rows if r is not None]
        if not live:
            return
        sampled = any(r.temperature > 0.0 for r in live)
        penalized = any(r.penalties != _NEUTRAL_PEN for r in live)
        if self.speculative:
            self._run_spec_segment(sampled, penalized)
        else:
            self._run_segment(sampled, penalized)

    def finished(self) -> List[Request]:
        """Drain and return requests completed since the last call."""
        out, self._finished = self._finished, []
        return out

    def request(self, req_id: int) -> Optional[Request]:
        """The still-running request with this id, or None (streaming
        front-ends poll row progress between segments)."""
        for req in self._rows:
            if req is not None and req.req_id == req_id:
                return req
        return None

    def cancel(self, req_id: int) -> bool:
        """Free the row serving ``req_id`` (e.g. a stop string matched on
        the host): the row is marked done on the card, so the next segment
        parks it and an admission can reuse it."""
        for row, req in enumerate(self._rows):
            if req is not None and req.req_id == req_id:
                self.state["done"][row] = True
                req.done = True
                self._rows[row] = None
                return True
        return False

    def run_until_drained(self) -> List[Request]:
        """Step until everything queued or in flight has completed; returns
        all finished requests."""
        done: List[Request] = []
        while not self.idle():
            self.step()
            done.extend(self.finished())
        return done

    # -- scheduler internals ---------------------------------------------------

    def _sample_rows(self, logits: torch.Tensor, sampled: bool) -> torch.Tensor:
        """One token per row of logits (B, V): the argmax where the row's
        temperature is <= 0, else a draw from its filtered distribution."""
        greedy = torch.argmax(logits, dim=-1)
        if not sampled:
            return greedy
        temp = self.state["temp"]
        masked, idx = _sampling_filter(logits, temp, self.state["topp"],
                                       self.top_k)
        choice = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                   generator=self._rng)
        drawn = torch.gather(idx, -1, choice)[:, 0]
        return torch.where(temp > 0.0, drawn, greedy)

    def _slices(self, seq: torch.Tensor, start: torch.Tensor,
                size: int) -> torch.Tensor:
        """seq[b, start[b]:start[b] + size] per row, the start clamped so
        that the slice lies in [0, max_len) (lax.dynamic_slice)."""
        start = start.clamp(0, self.max_len - size)
        idx = start[:, None] + torch.arange(size, device=seq.device)
        return torch.gather(seq, 1, idx)

    def _admit(self, row: int, req: Request) -> None:
        lb, max_len, st = self.length_bucket, self.max_len, self.state
        dev = self.device
        clipped = req.prompt_ids[-(max_len - 1 - lb):] or [self.pad_id]
        bucket = min(-(-len(clipped) // lb) * lb, max_len - 1 - lb)
        clipped = clipped[-bucket:]
        length = len(clipped)
        # the generation region is [bstart, max_len): the budget caps there
        nmax = min(req.max_tokens, max_len - 1 - bucket)
        ids = np.full((1, bucket), self.pad_id, np.int64)
        ids[0, :length] = clipped
        ids_t = torch.as_tensor(ids, device=dev)
        # prefill straight into the free row (views of the resident cache)
        row_cache = _rows(st["cache"], row)
        logits, _ = self.model(
            ids_t,
            positions=torch.arange(bucket, device=dev)[None, :],
            attention_mask=(torch.arange(max_len, device=dev)
                            < length)[None, :].int(),
            cache=row_cache,
            cache_pos=0,
            last_positions=torch.tensor([length - 1], device=dev),
        )
        last = logits[0, 0]
        pen = torch.tensor(req.penalties, dtype=torch.float32, device=dev)
        recent = _recent_window(ids_t[0], length, self.config.vocab_size)
        if req.penalties != _NEUTRAL_PEN:
            last = _penalize(last, recent, pen)
        first = TextGenerator._sample(last, self._rng, req.temperature,
                                      req.top_p, self.top_k)
        done = (first == self.eos) | (nmax <= 0)
        prompt_row = torch.zeros(st["seq"].shape[1], dtype=torch.long)
        prompt_row[:length] = torch.as_tensor(clipped)
        st["seq"][row] = prompt_row.to(dev)
        # the first token is committed into seq at bstart: speculative
        # drafts can match it, and the speculative readout flushes it
        st["seq"][row, bucket] = first
        st["token"][row] = first
        st["plen"][row] = length
        st["bstart"][row] = bucket
        # plain mode emits the first token in the next segment (ngen 0);
        # speculative mode counts it as generated already (ngen 1)
        st["ngen"][row] = (~done).long() if self.speculative else 0
        st["nmax"][row] = nmax
        st["done"][row] = done
        st["temp"][row] = req.temperature
        st["topp"][row] = req.top_p
        st["pen"][row] = pen
        st["recent"][row] = torch.cat([recent[1:], first[None]])
        self._rows[row] = req
        self._flushed[row] = 0

    def _run_segment(self, sampled: bool, penalized: bool) -> None:
        """Up to `segment` one-token forwards of every row; rows that finish
        are parked. Reads whether all rows are done once per forward, the
        tokens once at the end."""
        st, max_len, eos = self.state, self.max_len, self.eos
        plen, bstart, nmax, pen = st["plen"], st["bstart"], st["nmax"], st["pen"]
        token, ngen, done, recent = st["token"], st["ngen"], st["done"], st["recent"]
        out = torch.full((self.batch, self.segment), -1, dtype=torch.long,
                         device=self.device)
        kv_idx = torch.arange(max_len, device=self.device)[None, :]
        for i in range(self.segment):
            if bool(done.all()):
                break
            out[:, i] = torch.where(done, -1, token)
            slot = torch.where(done, max_len, bstart + ngen)
            kv_valid = (kv_idx < plen[:, None]) | (
                (kv_idx >= bstart[:, None]) & (kv_idx <= slot[:, None]))
            logits, _ = self.model(
                token[:, None],
                positions=(plen + ngen)[:, None],
                cache=st["cache"],
                cache_pos=slot,
                kv_valid=kv_valid,
            )
            last = logits[:, -1]
            if penalized:
                last = _penalize(last, recent, pen)
            nxt = self._sample_rows(last, sampled)
            if penalized:
                # live rows roll the committed token into their window
                recent = torch.where(
                    done[:, None], recent,
                    torch.cat([recent[:, 1:], nxt[:, None]], dim=1))
            ngen2 = torch.where(done, ngen, ngen + 1)
            done2 = done | (nxt == eos) | (ngen2 >= nmax) | (
                bstart + ngen2 >= max_len - 1)
            token = torch.where(done, token, nxt)
            ngen, done = ngen2, done2
        st.update(token=token, ngen=ngen, done=done, recent=recent)
        packed = torch.cat([out, done[:, None].long()], dim=1).cpu().numpy()
        for row in range(self.batch):
            req = self._rows[row]
            if req is None:
                continue
            req.tokens.extend(
                int(t) for t in packed[row, :-1] if t >= 0 and t != eos)
            if packed[row, -1]:
                req.done = True
                self._finished.append(req)
                self._rows[row] = None

    def _run_spec_segment(self, sampled: bool, penalized: bool) -> None:
        """Up to segment // 2 draft-and-verify forwards of every row (the
        batch-1 original is TextGenerator.generate_ids_spec). Drafting runs
        on the card: per row, the most recent committed occurrence of the
        row's last `ngram` tokens proposes its continuation (misses and
        gap-region matches draft junk, which is sound: only tokens equal to
        the argmax commit)."""
        st, max_len, eos = self.state, self.max_len, self.eos
        dev, batch = self.device, self.batch
        G, ng = self.draft_len, self.ngram
        iters = max(1, self.segment // 2)
        wmax = iters * (G + 1) + 1  # +1: the admission-sampled token
        n_win = max_len - ng
        plen, bstart, nmax, pen = st["plen"], st["bstart"], st["nmax"], st["pen"]
        seq, ngen, done, recent = st["seq"], st["ngen"], st["done"], st["recent"]
        key_slot = torch.arange(max_len, device=dev)
        wi = torch.arange(n_win, device=dev)[None, :]
        offs = torch.arange(G + 1, device=dev)
        window_idx = torch.arange(recent.shape[1], device=dev)[None, :]
        # draft acceptance verifies against the PLAIN argmax; penalties move
        # the argmax with every accepted token, so penalised rows, like
        # sampled ones, commit one token per forward
        exact = (st["temp"] <= 0.0) & (pen == torch.tensor(
            _NEUTRAL_PEN, device=dev)).all(dim=1)
        forwards = 0
        active = torch.zeros((), dtype=torch.long, device=dev)
        for _ in range(iters):
            if bool(done.all()):
                break
            active = active + (~done).sum()
            end = bstart + ngen  # the slot after the last committed token
            last = self._slices(seq, end - ng, ng)
            win = torch.stack([seq[:, l:l + n_win] for l in range(ng)], dim=2)
            match = (win == last[:, None, :]).all(dim=2)
            in_prompt = wi + ng <= plen[:, None]
            in_gen = (wi >= bstart[:, None]) & (wi + ng <= end[:, None])
            hit = match & (in_prompt | in_gen) & (wi < (end - ng)[:, None])
            cont_full = (wi + ng + G <= plen[:, None]) | (
                in_gen & (wi + ng + G <= end[:, None]))
            i_full = torch.where(hit & cont_full, wi, -1).amax(dim=1)
            i_any = torch.where(hit, wi, -1).amax(dim=1)
            i_best = torch.where(i_full >= 0, i_full, i_any)
            drafts = self._slices(
                seq, torch.where(i_best >= 0, i_best + ng, 0), G)

            # verify block [cur, d0 .. d_{G-1}] at slots end-1 .. end-1+G;
            # done rows park at max_len
            block = torch.cat([self._slices(seq, end - 1, 1), drafts], dim=1)
            slots_q = (end - 1)[:, None] + offs[None, :]
            kv_valid = (key_slot[None, None, :] < plen[:, None, None]) | (
                (key_slot[None, None, :] >= bstart[:, None, None])
                & (key_slot[None, None, :] <= slots_q[:, :, None]))
            logits, _ = self.model(
                block,
                positions=(plen + ngen - 1)[:, None] + offs[None, :],
                cache=st["cache"],
                cache_pos=torch.where(done, max_len, end - 1),
                kv_valid=kv_valid,
            )
            g = torch.argmax(logits, dim=-1)
            first = logits[:, 0]
            if penalized:
                first = _penalize(first, recent, pen)
            g = torch.cat([self._sample_rows(first, sampled)[:, None],
                           g[:, 1:]], dim=1)
            m = torch.cumprod((drafts == g[:, :G]).long(), dim=1).sum(dim=1)
            m = torch.where(exact, m, 0)
            hit_eos = (offs[None, :] <= m[:, None]) & (g == eos)
            any_eos = hit_eos.any(dim=1)
            c = torch.where(
                any_eos, torch.where(hit_eos, offs[None, :], G + 1).amin(dim=1),
                m + 1)
            c = torch.where(done, 0, torch.minimum(c, nmax - ngen))
            w_start = torch.where(done, max_len, end)
            seq.scatter_(1, w_start[:, None] + offs[None, :], g)
            if penalized:
                # shift each row's c committed tokens into its window
                recent = torch.gather(torch.cat([recent, g], dim=1), 1,
                                      c[:, None] + window_idx)
            ngen = ngen + c
            done = done | any_eos | (ngen >= nmax) | (
                bstart + ngen > max_len - G - 1)
            forwards += 1
        st.update(ngen=ngen, done=done, recent=recent)
        # the unflushed readout window of each row (only its first
        # ngen - flushed tokens are read, all inside seq)
        flushed = torch.as_tensor(self._flushed, device=dev)
        idx = (bstart + flushed)[:, None] + torch.arange(wmax, device=dev)
        window = torch.gather(seq, 1, idx.clamp(max=seq.shape[1] - 1))
        packed = torch.cat(
            [window, ngen[:, None], done[:, None].long(),
             active.reshape(1, 1).expand(batch, 1)], dim=1).cpu().numpy()
        window, ngen_h, done_h = packed[:, :-3], packed[:, -3], packed[:, -2]
        self.spec_stats["forwards"] += forwards
        self.spec_stats["row_forwards"] += int(packed[0, -1])
        for row in range(batch):
            req = self._rows[row]
            if req is None:
                continue
            fresh = int(ngen_h[row]) - int(self._flushed[row])
            self.spec_stats["tokens"] += fresh
            req.tokens.extend(int(t) for t in window[row, :fresh])
            self._flushed[row] = ngen_h[row]
            if done_h[row]:
                req.done = True
                self._finished.append(req)
                self._rows[row] = None
