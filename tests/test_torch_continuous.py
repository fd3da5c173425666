"""gen/continuous.py of the port (and the server's continuous mode) against
the JAX package's ContinuousBatcher on the same weights (Flax-initialised,
converted), f32 compute, on the CPU.

Greedy streams, plain and speculative, must EQUAL the JAX batcher's, and the
port's own single-request device loop's, whatever rows share the batch:
per-row slots, RoPE positions and kv masks are independent. Quantized
weights or KV round activations where a last-bit difference can flip a
rounding: those streams may first part at a step whose top-2 logit gap is
under 5e-2. Sampled rows draw from another generator than JAX's: they are
held to their seed and their budget."""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from persian_rag_tpu.gen import continuous as jc
from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu_torch.gen import continuous as tc
from persian_rag_tpu_torch.gen import generator as tg
from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
from persian_rag_tpu_torch.models import decoder as td

MAX_LEN = 128
VOCAB = tg.ByteTokenizer.vocab_size
NEAR_TIE = 5e-2
TOK = tg.ByteTokenizer()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax(seed=0):
    return jd.LlamaDecoder(jd.DecoderConfig.tiny(vocab_size=VOCAB)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


def _port(params, **kw):
    return tg.TextGenerator(td.DecoderConfig.tiny(vocab_size=VOCAB),
                            params=_np_tree(params), max_len=MAX_LEN,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX generator, port generator) over the same f32 weights."""
    params = _flax()
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(vocab_size=VOCAB),
                            params=params, tokenizer=jg.ByteTokenizer(),
                            max_len=MAX_LEN)
    return jgen, _port(params)


@pytest.fixture(scope="module")
def gen(pair):
    return pair[1]


def _ref(gen, text, max_tokens, **kw):
    ids = TOK.encode(text) if isinstance(text, str) else text
    return gen.generate_ids_device(ids, max_tokens=max_tokens,
                                   speculative=False, **kw)


def _equal_or_near_tie(gen, prompt, got, want):
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    ids = torch.tensor([list(prompt) + list(want[:i])])
    with torch.no_grad():
        top = torch.topk(gen.model(ids)[0, -1], 2).values
    assert float(top[0] - top[1]) < NEAR_TIE, (i, got, want)


STAGGERED = [("سوال اول درباره دارو", 24), ("متن دوم", 17),
             ("تکرار تکرار تکرار تکرار تکرار تکرار", 20)]


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_greedy_streams_equal_jax_batcher(pair, speculative):
    """Staggered admission into two rows, a third request reusing a row:
    every stream equals the JAX batcher's and the single-request loop's."""
    jgen, tgen = pair
    streams = []
    for gen, mod in ((jgen, jc), (tgen, tc)):
        cb = mod.ContinuousBatcher(gen, batch=2, segment=8,
                                   speculative=speculative, draft_len=4)
        cb.submit(TOK.encode(STAGGERED[0][0]), max_tokens=STAGGERED[0][1])
        cb.step()
        for text, budget in STAGGERED[1:]:
            cb.submit(TOK.encode(text), max_tokens=budget)
        streams.append({r.req_id: r.tokens for r in cb.run_until_drained()})
        if speculative:
            assert cb.spec_stats["forwards"] > 0
    assert streams[1] == streams[0]
    for rid, (text, budget) in enumerate(STAGGERED):
        assert streams[1][rid] == _ref(tgen, text, budget)


def test_single_request_matches_device_loop(gen):
    cb = tc.ContinuousBatcher(gen, batch=2, segment=8)
    rid = cb.submit(TOK.encode("سلام دنیا"), max_tokens=20)
    done = cb.run_until_drained()
    assert [r.req_id for r in done] == [rid]
    assert done[0].tokens == _ref(gen, "سلام دنیا", 20)
    assert cb.idle() and cb.request(rid) is None


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_mid_flight_admission_does_not_perturb_running_rows(gen, speculative):
    cb = tc.ContinuousBatcher(gen, batch=2, segment=4,
                              speculative=speculative)
    a = cb.submit(TOK.encode("سوال اول درباره دارو"), max_tokens=24)
    cb.step()
    cb.step()
    assert 0 < len(cb.request(a).tokens) < 24
    b = cb.submit(TOK.encode("متن دوم"), max_tokens=24)
    results = {r.req_id: r for r in cb.run_until_drained()}
    assert results[a].tokens == _ref(gen, "سوال اول درباره دارو", 24)
    assert results[b].tokens == _ref(gen, "متن دوم", 24)


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_row_reuse_across_many_requests(gen, speculative):
    """More requests than rows: finished rows are reclaimed and the
    overwritten cache does not leak into the next occupant."""
    prompts = [f"پرسش شماره {i} متن" for i in range(5)]
    budgets = [6, 18, 10, 14, 8]  # ragged completion order forces swaps
    cb = tc.ContinuousBatcher(gen, batch=2, segment=4,
                              speculative=speculative)
    ids = [cb.submit(TOK.encode(p), max_tokens=m)
           for p, m in zip(prompts, budgets)]
    results = {r.req_id: r.tokens for r in cb.run_until_drained()}
    assert set(results) == set(ids)
    for rid, p, m in zip(ids, prompts, budgets):
        assert results[rid] == _ref(gen, p, m), p


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_mixed_sampled_penalised_and_greedy_rows(gen, speculative):
    """A greedy row stays greedy-exact while a sampled row and a penalised
    greedy row share the batch (per-row temperature, top_p, penalties)."""
    pen = dict(repeat_penalty=1.3, frequency_penalty=0.2,
               presence_penalty=0.1)
    cb = tc.ContinuousBatcher(gen, batch=3, segment=8, seed=3,
                              speculative=speculative)
    g = cb.submit(TOK.encode("قطعی قطعی قطعی"), max_tokens=16)
    s = cb.submit(TOK.encode("نمونه"), max_tokens=16, temperature=1.0)
    p = cb.submit(TOK.encode("جریمه جریمه"), max_tokens=16, **pen)
    results = {r.req_id: r.tokens for r in cb.run_until_drained()}
    assert results[g] == _ref(gen, "قطعی قطعی قطعی", 16)
    assert results[p] == _ref(gen, "جریمه جریمه", 16, **pen)
    assert 0 < len(results[s]) <= 16
    assert all(0 <= t < VOCAB for t in results[s])


def test_sampled_rows_follow_their_seed(gen):
    def run(seed):
        cb = tc.ContinuousBatcher(gen, batch=2, segment=8, seed=seed)
        for text in ("نمونه اول", "نمونه دوم"):
            cb.submit(TOK.encode(text), max_tokens=12, temperature=0.9,
                      top_p=0.95)
        return {r.req_id: r.tokens for r in cb.run_until_drained()}

    assert run(7) == run(7)


def test_budget_and_empty_prompt_edge_cases(gen):
    cb = tc.ContinuousBatcher(gen, batch=2, segment=8)
    z = cb.submit(TOK.encode("تست"), max_tokens=0)
    e = cb.submit([], max_tokens=5)
    long = cb.submit(list(range(40, 250)), max_tokens=100)  # clipped prompt
    results = {r.req_id: r.tokens for r in cb.run_until_drained()}
    assert results[z] == []
    assert len(results[e]) <= 5
    # the prompt keeps its last max_len - 1 - 32 tokens, bucketed to 95,
    # and the generation region [bstart, max_len) caps the budget
    assert 0 < len(results[long]) <= MAX_LEN - 1 - 95


def test_cancel_frees_the_row(gen):
    cb = tc.ContinuousBatcher(gen, batch=1, segment=4)
    a = cb.submit(TOK.encode("سوال اول"), max_tokens=40)
    b = cb.submit(TOK.encode("متن دوم"), max_tokens=8)
    cb.step()
    assert cb.cancel(a) and not cb.cancel(a) and cb.request(a) is None
    results = {r.req_id: r.tokens for r in cb.run_until_drained()}
    assert set(results) == {b}
    assert results[b] == _ref(gen, "متن دوم", 8)


def test_speculative_auto_demotes_on_poor_acceptance(gen, monkeypatch):
    """Repeat-free prompts starve the n-gram lookup: almost every verify
    forward commits ~1 token per row, so 'auto' demotes itself at the next
    empty-batch boundary; streams stay equal to plain greedy throughout."""
    monkeypatch.setattr(tc.ContinuousBatcher, "SPEC_AUTO_MIN_FORWARDS", 4)
    cb = tc.ContinuousBatcher(gen, batch=2, segment=8, speculative="auto")
    assert cb.speculative and not cb.spec_demoted
    prompts = [list(range(40, 72)), list(range(80, 112)),
               list(range(120, 152))]
    for p in prompts[:2]:
        cb.submit(p, max_tokens=16)
    done = {r.req_id: r for r in cb.run_until_drained()}
    cb.submit(prompts[2], max_tokens=16)
    done.update({r.req_id: r for r in cb.run_until_drained()})
    assert cb.spec_demoted and not cb.speculative, cb.spec_stats
    for rid, p in zip(sorted(done), prompts):
        assert done[rid].tokens == _ref(gen, p, 16), p[:4]


def _zeroed(params):
    """Zeroed o_proj and down_proj: the residual stream is the token's own
    embedding, so greedy repeats one token forever (the lookup drafter's
    best case)."""
    tree = _np_tree(params)
    for name, layer in tree.items():
        if name.startswith("layer_"):
            for a, b in (("attention", "o_proj"), ("mlp", "down_proj")):
                layer[a][b]["kernel"] = np.zeros_like(layer[a][b]["kernel"])
    return tree


def test_speculative_auto_keeps_drafting_on_high_acceptance(monkeypatch):
    g = _port(_zeroed(_flax(3)))
    monkeypatch.setattr(tc.ContinuousBatcher, "SPEC_AUTO_MIN_FORWARDS", 2)
    cb = tc.ContinuousBatcher(g, batch=2, segment=8, speculative="auto")
    for _ in range(2):
        cb.submit(TOK.encode("تکرار تکرار"), max_tokens=24)
        cb.run_until_drained()
        cb.step()  # crosses an empty boundary; must NOT demote
    assert cb.speculative and not cb.spec_demoted
    assert cb.spec_stats["tokens"] > 2 * cb.spec_stats["row_forwards"]


def test_auto_normaliser_counts_rows_active_at_each_forward(monkeypatch):
    """One long high-acceptance row beside seven one-token rows that finish
    at the segment's first verify forward. The JAX batcher multiplies the
    segment's forwards by the 8 rows active at its start and demotes; the
    port counts the rows active at each forward and keeps drafting, as the
    true acceptance (tokens per active-row forward) clears the floor."""
    params = _zeroed(_flax(3))
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(vocab_size=VOCAB),
                            params=jax.tree_util.tree_map(jnp.asarray, params),
                            tokenizer=jg.ByteTokenizer(), max_len=MAX_LEN)
    outcome = {}
    for name, gen, mod in (("jax", jgen, jc), ("port", _port(params), tc)):
        monkeypatch.setattr(mod.ContinuousBatcher, "SPEC_AUTO_MIN_FORWARDS", 4)
        cb = mod.ContinuousBatcher(gen, batch=8, segment=16,
                                   speculative="auto")
        cb.submit(TOK.encode("تکرار تکرار"), max_tokens=48)
        for i in range(7):
            cb.submit(TOK.encode(f"کوتاه {i}"), max_tokens=1)
        streams = {r.req_id: r.tokens for r in cb.run_until_drained()}
        cb.step()  # the empty-batch boundary where "auto" decides
        outcome[name] = (cb.spec_demoted, dict(cb.spec_stats), streams)
    (j_demoted, j_stats, j_streams), (t_demoted, t_stats, t_streams) = (
        outcome["jax"], outcome["port"])
    assert t_streams == j_streams
    assert t_stats["tokens"] == j_stats["tokens"]
    assert t_stats["forwards"] == j_stats["forwards"]
    floor = tc.ContinuousBatcher.SPEC_AUTO_TPF_FLOOR
    assert j_stats["tokens"] < floor * j_stats["row_forwards"], j_stats
    assert t_stats["tokens"] >= floor * t_stats["row_forwards"], t_stats
    assert j_demoted and not t_demoted


@pytest.mark.parametrize("kw", [dict(quantize="int4"), dict(quantize_kv=True)],
                         ids=["int4", "int8_kv"])
@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_quantized_serving_with_continuous(kw, speculative):
    g = _port(_flax(2), **kw)
    cb = tc.ContinuousBatcher(g, batch=2, segment=8, speculative=speculative)
    texts = [("دارو چیست؟ دارو چیست؟", 14), ("متن دوم", 10), ("سوم", 12)]
    ids = [cb.submit(TOK.encode(t), max_tokens=m) for t, m in texts]
    results = {r.req_id: r.tokens for r in cb.run_until_drained()}
    for rid, (text, m) in zip(ids, texts):
        _equal_or_near_tie(g, TOK.encode(text), results[rid],
                           _ref(g, text, m))


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/completion", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers["Content-Type"], r.read()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "spec"])
def test_server_continuous_mode(gen, speculative):
    """Concurrent /completion requests return the single-request greedy
    answers; a stream's chunks add up to its answer; a stop string cancels
    its row; /props and /slots report the batcher."""
    server = LocalGenerationServer(gen, max_batch=2, continuous=True,
                                   segment=4, speculative=speculative)
    with server as url:
        props = _get(url, "/props")
        assert props["continuous_batching"] is True
        assert props["total_slots"] == 2
        assert _get(url, "/slots") == [{"id": 0, "state": 0},
                                       {"id": 1, "state": 0}]
        results = [None] * 3
        slots_seen = []

        def hit(i):
            results[i] = json.loads(_post(url, {
                "prompt": f"سوال {i} درباره دارو", "n_predict": 24})[1])

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            slots_seen.append(_get(url, "/slots"))
        for t in threads:
            t.join(timeout=120)
        ctype, body = _post(url, {"prompt": "سوال 0 درباره دارو",
                                  "n_predict": 24, "stream": True})
        frames = [json.loads(f[6:]) for f in body.split(b"\n\n")
                  if f.startswith(b"data: ")]
        full = TOK.decode(_ref(gen, "سوال 1 درباره دارو", 24))
        assert len(full) >= 4
        stop = full[len(full) // 2:][:2]
        cut = json.loads(_post(url, {"prompt": "سوال 1 درباره دارو",
                                     "n_predict": 24, "stop": [stop]})[1])
    assert server.errors == 0, server.error_log
    for i in range(3):
        want = TOK.decode(_ref(gen, f"سوال {i} درباره دارو", 24))
        assert results[i] == {"content": want}
    assert any(sum(s["state"] for s in snap) == 2 for snap in slots_seen)
    assert all("req_id" in s for snap in slots_seen for s in snap
               if s["state"] == 1)
    assert ctype.startswith("text/event-stream") and frames[-1]["stop"]
    assert "".join(f["content"] for f in frames) == results[0]["content"]
    assert cut["content"] == full[:full.find(stop)]


def test_server_counts_a_failed_segment_and_rebuilds(gen):
    server = LocalGenerationServer(gen, max_batch=2, continuous=True,
                                   segment=4)
    first = server._batcher

    def broken():
        raise RuntimeError("kernel launch failed")

    first.step = broken
    with server as url:
        out = json.loads(_post(url, {"prompt": "hi", "n_predict": 4})[1])
        again = json.loads(_post(url, {"prompt": "سلام", "n_predict": 6})[1])
    assert out == {"content": ""}  # the contract: an empty answer
    assert server.errors == 1 and "kernel launch failed" in server.error_log[0]
    assert server._batcher is not first
    assert again == {"content": TOK.decode(_ref(gen, "سلام", 6))}
