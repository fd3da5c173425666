"""Text generation on top of the PyTorch Llama decoder.

The counterpart of ``persian_rag_tpu.gen.generator``: prefill plus
incremental KV-cache decoding with greedy or temperature / top-k / top-p
sampling, llama.cpp's penalty chain, a ragged batched loop, prompt-lookup
speculative decoding and hidden-state embeddings. Tokenization is
pluggable; the self-contained `ByteTokenizer` (UTF-8 bytes + specials)
needs no files.

The JAX package compiles each loop into one ``lax.while_loop``; here they
are host loops over eager forwards, and every end-of-stream test reads a
token back from the device. Greedy streams equal the JAX package's token
for token. Sampled streams cannot: they draw from a seeded
``torch.Generator`` (deterministic per seed), after the same filter
(penalties -> top-k -> softmax -> cumulative cut). Ties go to the lowest
token id everywhere, as ``jnp.argmax`` and ``lax.top_k`` break them.

With a `mesh` (``core.mesh``) the decoder serves tensor-parallel over its
`tp_axis` (``parallel.tp_decoder.TPLlamaDecoder``): the same loops, the
same token streams, a KV cache per attention shard; projections stay
unfused there, as in the JAX package.

Prompt lengths keep the 32-wide buckets (they fix the cache slots of the
batched and speculative loops); the power-of-two batch padding, which only
bounded jit compiles, is gone. A prefill keeps one position per row before
the lm_head (``LlamaDecoder(last_positions=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.core.mesh import check_mesh
from persian_rag_tpu_torch.models.convert import (
    as_tensor,
    decoder_params_from_flax,
)
from persian_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    LlamaDecoder,
    cast_params,
    fuse_params,
    init_cache,
    quantize_decoder_params,
    random_params,
)


def _is_quantized_tree(params) -> bool:
    embed = params.get("embed_tokens", {})
    return isinstance(embed, dict) and "values" in embed


# llama.cpp's repeat_last_n default: the window of context tokens the
# penalty chain looks back over.
PENALTY_LAST_N = 64


def _recent_window(ids: torch.Tensor, length, vocab_size: int) -> torch.Tensor:
    """Last PENALTY_LAST_N context tokens of right-padded id rows.

    ids (..., L) integer, length (...) = number of valid tokens per row (a
    tensor or an int). Slots before the start of a short prompt read the
    ``vocab_size`` sentinel, which `_penalize` drops."""
    length = torch.as_tensor(length, device=ids.device)
    idx = length[..., None] - PENALTY_LAST_N + torch.arange(
        PENALTY_LAST_N, device=ids.device)
    got = torch.gather(ids, -1, idx.clamp(0, ids.shape[-1] - 1))
    return torch.where(idx >= 0, got, torch.full_like(got, vocab_size))


def _penalize(logits: torch.Tensor, recent: torch.Tensor, pen) -> torch.Tensor:
    """llama.cpp sampler-chain penalties, applied before top-k / top-p and
    before the greedy argmax. logits (..., V), recent (..., W) token ids
    (ids outside [0, V) count for nothing), pen = (repeat, frequency,
    presence):

    - repeat: binary presence over the window; positive logits divide,
      negative multiply;
    - frequency / presence: logit -= count * freq + (count > 0) * present.

    pen is (3,), or (..., 3) with one triple per row of logits. Neutral
    pen (1, 0, 0) is an exact identity."""
    v = logits.shape[-1]
    pen = torch.as_tensor(pen, dtype=torch.float32, device=logits.device)
    repeat, freq, present = (pen[..., i, None] for i in range(3))
    idx = recent.long()
    # an out-of-range id lands in a spare column that is cut off again
    idx = torch.where((idx >= 0) & (idx < v), idx, torch.full_like(idx, v))
    counts = torch.zeros((*logits.shape[:-1], v + 1), dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.float32))
    counts = counts[..., :v]
    out = logits.float()
    seen = counts > 0
    out = torch.where(seen, torch.where(out > 0, out / repeat, out * repeat), out)
    return out - counts * freq - seen.float() * present


def _sampling_filter(logits: torch.Tensor, temperature: float, top_p: float,
                     top_k: int = 40):
    """The sampler's filter: logits (..., V) -> (masked (..., C) scaled
    logits, descending, -inf past the nucleus; idx (..., C) their token
    ids). C = top_k when 0 < top_k < V (llama.cpp applies top-k before
    top-p), else V. temperature and top_p are numbers, or tensors (...)
    with one value per row."""
    if isinstance(temperature, torch.Tensor):
        scaled = logits / temperature.clamp(min=1e-6)[..., None]
        top_p = top_p[..., None]
    else:
        scaled = logits / max(float(temperature), 1e-6)
    vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    if 0 < top_k < scaled.shape[-1]:
        vals, idx = vals[..., :top_k], idx[..., :top_k]
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cut = cum - probs > top_p  # keep tokens until the mass passes top_p
    return torch.where(cut, torch.full_like(vals, -torch.inf), vals), idx


def _dslice(arr: np.ndarray, start: int, size: int) -> np.ndarray:
    """arr[start:start + size] with the start clamped so that the slice
    fits (lax.dynamic_slice)."""
    start = min(max(int(start), 0), len(arr) - size)
    return arr[start:start + size]


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 bytes, 256=BOS, 257=EOS."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="ignore")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return as_tensor(tree).to(device)


class TextGenerator:
    def __init__(
        self,
        config: DecoderConfig,
        params: Optional[Dict] = None,
        tokenizer=None,
        max_len: int = 512,
        seed: int = 0,
        mesh=None,
        tp_axis: str = "corpus",
        fuse_projections: bool = False,
        quantize=False,  # False | True / 'int8' | 'int4'
        quantize_kv: bool = False,
        device=None,
    ):
        self.mesh = check_mesh(mesh)
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        if quantize_kv and config.kv_cache_dtype != "int8":
            config = dataclasses.replace(config, kv_cache_dtype="int8")
        if quantize and not config.quantized_weights:
            # "int4" packs the layer projections two nibbles a byte; the
            # embedding and an untied lm_head stay int8
            config = dataclasses.replace(
                config, quantized_weights=True,
                quantized_bits=4 if quantize == "int4" else 8)
        if mesh is not None and config.fused_projections:
            raise ValueError("a tensor-parallel decoder serves unfused "
                             "projections: pass the unfused tree")
        if fuse_projections and mesh is None and not config.fused_projections:
            config = dataclasses.replace(config, fused_projections=True)
            if params is not None:
                params = fuse_params(params)
        self.config = config
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_len = min(max_len, config.max_position_embeddings)
        if params is None:
            # random-weight serving: a FLOAT tree, quantized below
            params = random_params(config, seed=seed, device=self.device)
            if config.fused_projections:
                params = fuse_params(params)
        # serve weights in the compute dtype; quantized pairs pass through
        params = cast_params(_tree_to(params, self.device),
                             config.compute_dtype)
        if config.quantized_weights and not _is_quantized_tree(params):
            params = quantize_decoder_params(params,
                                             bits=config.quantized_bits)
        self.params = params
        if mesh is not None:
            from persian_rag_tpu_torch.parallel.tp_decoder import (
                TPLlamaDecoder,
            )

            self.model = TPLlamaDecoder(config, params, mesh, tp_axis)
        else:
            with torch.device("meta"):
                self.model = LlamaDecoder(config)
            # the module takes the tree's tensors as they are (no copy)
            self.model.load_state_dict(
                decoder_params_from_flax(params, config), assign=True)
        self.model.requires_grad_(False).eval()
        self.last_spec_stats: Dict[str, float] = {}

    @classmethod
    def from_gguf(
        cls,
        path: str,
        max_len: int = 512,
        quantize=None,
        device=None,
        **kw,
    ) -> "TextGenerator":
        """Serve a llama.cpp GGUF file (the reference's serving artifact is
        a Llama-3.2-1B Q8_0 GGUF): the weights dequantize to f32 on the
        serving device, are cast to bf16 and re-quantized for the port's
        kernels; the embedded BPE tokenizer is rebuilt from the file's
        metadata (a file without one gets the ByteTokenizer).
        ``quantize`` defaults to int8 when the file is quantized and to
        False for f16 / f32 / bf16 files; "int4" packs the layer
        projections for #18."""
        from persian_rag_tpu_torch.models.gguf import (
            GGML_BF16,
            GGML_F16,
            GGML_F32,
            GGUFFile,
            params_from_gguf,
            tokenizer_from_gguf,
        )

        device = resolve_device(device)
        gf = GGUFFile(path)
        try:
            config, params = params_from_gguf(
                gf, device=device, compute_dtype=torch.bfloat16)
            tokenizer = tokenizer_from_gguf(gf)
            if quantize is None:
                float_types = (GGML_F32, GGML_F16, GGML_BF16)
                quantize = any(
                    t.ggml_type not in float_types
                    for t in gf.tensors.values()
                )
        finally:
            gf.close()
        return cls(config, params=params, tokenizer=tokenizer,
                   max_len=max_len, quantize=quantize, device=device, **kw)

    # -- forward pieces --------------------------------------------------------

    def new_cache(self, batch: int, max_len: int):
        """An empty KV cache for `batch` rows of `max_len` slots (one per
        attention shard on a mesh)."""
        if self.mesh is not None:
            return self.model.new_cache(batch, max_len)
        return init_cache(self.config, batch, max_len, self.device)

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.long, device=self.device)

    def _prefill(self, prompt_ids: Sequence[int]):
        """Logits (V,) after the prompt's last token, and the cache."""
        length = len(prompt_ids)
        cache = self.new_cache(1, self.max_len)
        logits, cache = self.model(
            self._ints([list(prompt_ids)]),
            positions=torch.arange(length, device=self.device)[None, :],
            cache=cache,
            cache_pos=0,
            last_positions=self._ints([length - 1]),
        )
        return logits[0, 0], cache

    def _step(self, token, pos: int, cache) -> torch.Tensor:
        """Logits (V,) after one token at position (= cache slot) `pos`."""
        token = torch.as_tensor(token, device=self.device).long()
        logits, _ = self.model(
            token.reshape(1, 1),
            positions=self._ints([[pos]]),
            cache=cache,
            cache_pos=pos,
        )
        return logits[0, -1]

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    @staticmethod
    def _sample(logits, gen, temperature, top_p, top_k=40) -> torch.Tensor:
        """One token id per row of logits (..., V): the argmax when
        temperature <= 0, else a draw from the filtered distribution."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        masked, idx = _sampling_filter(logits, temperature, top_p, top_k)
        probs = torch.softmax(masked, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        choice = torch.multinomial(flat, 1, generator=gen)
        choice = choice.reshape(*probs.shape[:-1], 1)
        return torch.gather(idx, -1, choice).squeeze(-1)

    def _pen(self, repeat_penalty, frequency_penalty, presence_penalty):
        penalized = (repeat_penalty != 1.0 or frequency_penalty != 0.0
                     or presence_penalty != 0.0)
        pen = torch.tensor(
            [repeat_penalty, frequency_penalty, presence_penalty],
            dtype=torch.float32, device=self.device)
        return penalized, pen

    def _device_loop(self, prompt_ids, max_tokens, temperature, top_p, seed,
                     top_k, penalized, pen) -> List[int]:
        """Exact-length single-prompt loop with the penalty chain."""
        eos = getattr(self.tokenizer, "eos_id", -1)
        vocab = self.config.vocab_size
        gen = self._generator(seed)
        last, cache = self._prefill(prompt_ids)
        recent = None
        if penalized:
            recent = _recent_window(
                self._ints(list(prompt_ids)), len(prompt_ids), vocab)
            last = _penalize(last, recent, pen)
        token = self._sample(last, gen, temperature, top_p, top_k)
        if penalized:
            recent = torch.cat([recent[1:], token[None]])
        out: List[int] = []
        pos = len(prompt_ids)
        while len(out) < max_tokens and int(token) != eos:
            out.append(int(token))
            last = self._step(token, pos, cache)
            pos += 1
            if penalized:
                last = _penalize(last, recent, pen)
            token = self._sample(last, gen, temperature, top_p, top_k)
            if penalized:
                recent = torch.cat([recent[1:], token[None]])
        return out

    # -- public API --------------------------------------------------------------

    @torch.no_grad()
    def generate_ids_spec(
        self,
        prompt_ids: Sequence[int],
        max_tokens: int = 128,
        draft_len: int = 7,
        ngram: int = 3,
        length_bucket: int = 32,
    ) -> List[int]:
        """Greedy generation with prompt-lookup speculative decoding:
        token-identical to plain greedy.

        Each iteration drafts `draft_len` tokens by finding the most
        recent earlier occurrence of the last `ngram` tokens in prompt +
        output and proposing its continuation, then verifies the block in
        one (draft_len + 1)-token forward and keeps the longest prefix
        that equals the argmax (plus one corrected token). The prompt is
        LEFT-padded to its bucket so that cache slots stay contiguous with
        the generation (slot = position + pad); pads are masked per query
        and RoPE uses true positions. Drafting runs on the host over the
        committed tokens; `last_spec_stats` says how many tokens each
        forward yielded."""
        G, ng = draft_len, ngram
        dev, max_len = self.device, self.max_len
        eos = getattr(self.tokenizer, "eos_id", -1)
        clip = max_len - max_tokens - G - 2
        prompt_ids = list(prompt_ids)[-clip:]
        bucket = min(-(-len(prompt_ids) // length_bucket) * length_bucket, clip)
        pad = bucket - len(prompt_ids)
        ids = np.full((bucket,), getattr(self.tokenizer, "pad_id", 0), np.int64)
        ids[pad:] = prompt_ids
        n_win = max_len - ng
        key_slot = torch.arange(max_len, device=dev)
        win_idx = np.arange(n_win)

        # prefill: the query at slot q sees the keys [pad, q]
        cache = self.new_cache(1, max_len)
        slots = torch.arange(bucket, device=dev)
        kv_valid = (key_slot[None, None, :] >= pad) & (
            key_slot[None, None, :] <= slots[None, :, None])
        logits, cache = self.model(
            self._ints(ids[None, :]),
            positions=(slots - pad).clamp(min=0)[None, :],
            cache=cache,
            cache_pos=0,
            kv_valid=kv_valid,
            last_positions=self._ints([bucket - 1]),
        )
        first = int(torch.argmax(logits[0, 0]))

        # seq: slot-aligned tokens, committed on [0, end); the token at
        # end - 1 is committed but not yet in the cache
        seq = np.zeros((max_len,), np.int64)
        seq[:bucket] = ids
        seq[bucket] = first
        out = np.full((max_tokens + G + 1,), -1, np.int64)
        out[0] = first
        done = first == eos
        n = 0 if done else 1
        end = bucket + 1
        iters = 0
        offs = np.arange(G + 1)
        while n < max_tokens and not done and end <= max_len - G - 1:
            # draft: the most recent match whose G-token continuation is
            # fully committed, else the most recent partial match (its
            # tail reads the last block's unverified predictions); a miss
            # drafts from slot 0. All sound: only argmax matches commit.
            last = _dslice(seq, end - ng, ng)
            win = np.stack([seq[l:l + n_win] for l in range(ng)], axis=1)
            hit = (win == last[None, :]).all(axis=1) & (win_idx >= pad) & (
                win_idx < end - ng)
            i_full = np.max(np.where(hit & (win_idx + ng + G <= end), win_idx, -1))
            i_any = np.max(np.where(hit, win_idx, -1))
            i_best = i_full if i_full >= 0 else i_any
            drafts = _dslice(seq, i_best + ng if i_best >= 0 else 0, G)

            # verify block [cur, d0 .. d_{G-1}] at slots end-1 .. end-1+G;
            # it overwrites the stale draft K/V of the last iteration
            block = np.concatenate([seq[end - 1:end], drafts])
            slots_b = end - 1 + torch.arange(G + 1, device=dev)
            kv_valid = (key_slot[None, None, :] >= pad) & (
                key_slot[None, None, :] <= slots_b[None, :, None])
            logits, cache = self.model(
                self._ints(block[None, :]),
                positions=(slots_b - pad)[None, :],
                cache=cache,
                cache_pos=end - 1,
                kv_valid=kv_valid,
            )
            g = torch.argmax(logits[0], dim=-1).cpu().numpy()
            # the longest prefix of drafts equal to the argmax; emitted
            # tokens are g[0..m] (m accepted + 1 correction)
            m = int(np.sum(np.cumprod(drafts == g[:G])))
            hit_eos = (offs <= m) & (g == eos)
            c = int(offs[hit_eos].min()) if hit_eos.any() else m + 1
            c = min(c, max_tokens - n)
            seq[end:end + G + 1] = g
            out[n:n + G + 1] = g
            n, end, done, iters = n + c, end + c, bool(hit_eos.any()), iters + 1

        # +1 forward for the prefill-sampled first token
        self.last_spec_stats = {
            "tokens": n,
            "forwards": iters + 1,
            "tokens_per_forward": n / max(iters + 1, 1),
        }
        return [int(t) for t in out[:n] if t != eos]

    @torch.no_grad()
    def generate_batch_device(
        self,
        prompts_ids: Sequence[Sequence[int]],
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        seed: int = 0,
        length_bucket: int = 32,
        top_k: int = 40,
        repeat_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
    ) -> List[List[int]]:
        """Generate for a batch of ragged prompts in one loop: prompts
        right-padded to one bucket, per-row positions and EOS masking.
        One sampler setting per call (the server groups same-sampler
        requests); the penalties look back over the last PENALTY_LAST_N
        context tokens and apply before top-k and before the greedy
        argmax.

        RoPE's position is per row, but every row's step-t token lands in
        the same cache slot bucket + t, so the KV write is one slice
        assignment; pad slots [len_i, bucket) stay masked forever."""
        batch = len(prompts_ids)
        if batch == 0:
            return []
        dev, max_len = self.device, self.max_len
        eos = getattr(self.tokenizer, "eos_id", -1)
        vocab = self.config.vocab_size
        limit = max_len - max_tokens - 1
        clipped = [list(p)[-limit:] for p in prompts_ids]
        longest = max(len(p) for p in clipped)
        bucket = min(-(-longest // length_bucket) * length_bucket, limit)
        ids_np = np.full((batch, bucket), getattr(self.tokenizer, "pad_id", 0),
                         np.int64)
        for i, p in enumerate(clipped):
            ids_np[i, : len(p)] = p
        ids = self._ints(ids_np)
        lengths = self._ints([len(p) for p in clipped])
        penalized, pen = self._pen(
            repeat_penalty, frequency_penalty, presence_penalty)
        gen = self._generator(seed)

        cache = self.new_cache(batch, max_len)
        key_slot = torch.arange(max_len, device=dev)[None, :]
        logits, cache = self.model(
            ids,
            positions=torch.arange(bucket, device=dev)[None, :].expand(
                batch, bucket),
            attention_mask=(key_slot < lengths[:, None]).int(),
            cache=cache,
            cache_pos=0,
            last_positions=lengths - 1,
        )
        last = logits[:, 0]
        recent = None
        if penalized:
            recent = _recent_window(ids, lengths, vocab)
            last = _penalize(last, recent, pen)
        token = self._sample(last, gen, temperature, top_p, top_k)
        if penalized:
            recent = torch.cat([recent[:, 1:], token[:, None]], dim=1)
        done = token == eos
        out = torch.full((batch, max_tokens), -1, dtype=torch.long, device=dev)
        t = 0
        while t < max_tokens and not bool(done.all()):
            out[:, t] = torch.where(done, -1, token)
            pos = (lengths + t).clamp(max=max_len - 1)
            kv_valid = (key_slot < lengths[:, None]) | (
                (key_slot >= bucket) & (key_slot <= bucket + t))
            logits, cache = self.model(
                token[:, None],
                positions=pos[:, None],
                cache=cache,
                cache_pos=min(bucket + t, max_len - 1),
                kv_valid=kv_valid,
            )
            last = logits[:, -1]
            if penalized:
                last = _penalize(last, recent, pen)
            nxt = self._sample(last, gen, temperature, top_p, top_k)
            if penalized:
                recent = torch.cat([recent[:, 1:], nxt[:, None]], dim=1)
            done = done | (nxt == eos) | (lengths + t + 1 >= max_len - 1)
            t, token = t + 1, nxt
        return [
            [int(v) for v in row if v >= 0 and v != eos]
            for row in out.cpu().numpy()
        ]

    @torch.no_grad()
    def embed_batch(
        self,
        prompts_ids: Sequence[Sequence[int]],
        length_bucket: int = 32,
    ) -> np.ndarray:
        """Decoder-hidden-state embeddings for ragged token prompts
        (llama.cpp ``--embedding``): mean pooling of the final-norm hidden
        states over the prompt tokens, L2-normalized. (B, H) float32."""
        batch = len(prompts_ids)
        if batch == 0:
            return np.zeros((0, self.config.hidden_size), np.float32)
        clipped = [list(p)[: self.max_len] or [0] for p in prompts_ids]
        longest = max(len(p) for p in clipped)
        bucket = min(-(-longest // length_bucket) * length_bucket, self.max_len)
        ids = np.full((batch, bucket), getattr(self.tokenizer, "pad_id", 0),
                      np.int64)
        mask = np.zeros((batch, bucket), np.int64)
        for i, p in enumerate(clipped):
            ids[i, : len(p)] = p
            mask[i, : len(p)] = 1
        mask_t = self._ints(mask)
        hidden = self.model(
            self._ints(ids), attention_mask=mask_t, return_hidden=True
        ).float()
        m = mask_t.float()[:, :, None]
        pooled = (hidden * m).sum(1) / m.sum(1).clamp(min=1.0)
        norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return (pooled / norm.clamp(min=1e-12)).cpu().numpy()

    def embed_text(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize + embed_batch (llama.cpp /embedding contract)."""
        return self.embed_batch([self.tokenizer.encode(t) for t in texts])

    @torch.no_grad()
    def generate_ids_device(
        self,
        prompt_ids: Sequence[int],
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        seed: int = 0,
        top_k: int = 40,
        bucket_lengths: bool = True,
        speculative: Optional[bool] = None,
        repeat_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
    ) -> List[int]:
        """One request's whole generation; stops at EOS.

        Greedy requests without penalties default to the prompt-lookup
        SPECULATIVE loop (token-identical output; penalties change the
        argmax, so penalized requests decode one token per step). Others
        go through the ragged batch loop at batch 1, or with
        bucket_lengths=False through the exact-length loop (same
        outputs)."""
        penalized, pen = self._pen(
            repeat_penalty, frequency_penalty, presence_penalty)
        if speculative is None:
            speculative = temperature <= 0.0 and not penalized
        if speculative and temperature <= 0.0 and not penalized:
            return self.generate_ids_spec(prompt_ids, max_tokens=max_tokens)
        if bucket_lengths:
            return self.generate_batch_device(
                [prompt_ids], max_tokens=max_tokens,
                temperature=temperature, top_p=top_p, seed=seed,
                top_k=top_k, repeat_penalty=repeat_penalty,
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
            )[0]
        prompt_ids = list(prompt_ids)[-(self.max_len - max_tokens - 1):]
        return self._device_loop(prompt_ids, max_tokens, temperature, top_p,
                                 seed, top_k, penalized, pen)

    @torch.no_grad()
    def generate_ids(
        self,
        prompt_ids: Sequence[int],
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        stop_ids: Optional[Sequence[int]] = None,
        seed: int = 0,
        top_k: int = 40,
    ) -> List[int]:
        """The per-step loop: one forward and one token read per step."""
        stop = set(stop_ids or [])
        eos = getattr(self.tokenizer, "eos_id", None)
        if eos is not None:
            stop.add(eos)
        prompt_ids = list(prompt_ids)[-(self.max_len - max_tokens - 1):]
        logits, cache = self._prefill(prompt_ids)
        gen = self._generator(seed)
        out: List[int] = []
        pos = len(prompt_ids)
        token = int(self._sample(logits, gen, temperature, top_p, top_k))
        for _ in range(max_tokens):
            if token in stop or pos >= self.max_len - 1:
                break
            out.append(token)
            logits = self._step(token, pos, cache)
            pos += 1
            token = int(self._sample(logits, gen, temperature, top_p, top_k))
        return out

    def generate_text(
        self,
        prompt: str,
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        stop: Optional[Sequence[str]] = None,
        seed: int = 0,
        top_k: int = 40,
    ) -> str:
        out_ids = self.generate_ids(
            self.tokenizer.encode(prompt),
            max_tokens=max_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=seed,
            top_k=top_k,
        )
        text = self.tokenizer.decode(out_ids)
        for marker in stop or []:
            idx = text.find(marker)
            if idx >= 0:
                text = text[:idx]
        return text
