"""gen/generator.py of the port against the JAX package's TextGenerator on
the same weights (Flax-initialised, converted), f32 compute, on the CPU.

Greedy token streams must be EQUAL for the host loop, the device loop
(bucketed and exact-length), the ragged batch loop and the speculative loop,
with penalties, an early EOS and prompts clipped to max_len. Sampled streams
cannot be equal (other random bits): the filter is held to the JAX
sampler's draws and the stream to its seed. Quantized weights round
activations to bf16, where a last-bit difference upstream can flip a
rounding: those streams may first differ at a step whose top-2 logit gap
is under 5e-2."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu_torch.gen import generator as tg
from persian_rag_tpu_torch.models import decoder as td

MAX_LEN = 96
PROMPT = "دارو چیست؟ دارو چیست؟ دارو"
NEAR_TIE = 5e-2


class _JEos(jg.ByteTokenizer):
    pass


class _TEos(tg.ByteTokenizer):
    pass


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX generator, port generator) over the same f32 weights."""
    params = jd.LlamaDecoder(jd.DecoderConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(), params=params,
                            max_len=MAX_LEN)
    tgen = tg.TextGenerator(td.DecoderConfig.tiny(), params=_np_tree(params),
                            max_len=MAX_LEN, device="cpu")
    return jgen, tgen


@pytest.fixture(scope="module")
def prompt():
    return jg.ByteTokenizer().encode(PROMPT)


def test_tokenizers_equal():
    j, t = jg.ByteTokenizer(), tg.ByteTokenizer()
    text = "سلام world ۱۲۳"
    assert t.encode(text) == j.encode(text)
    assert t.encode(text, add_bos=False) == j.encode(text, add_bos=False)
    assert t.decode(t.encode(text) + [257, 300]) == text
    assert (t.vocab_size, t.bos_id, t.eos_id) == (258, 256, 257)
    assert tg.PENALTY_LAST_N == jg.PENALTY_LAST_N


ROUTES = {
    "host": lambda g, p, **kw: g.generate_ids(p, max_tokens=12),
    "device": lambda g, p, **kw: g.generate_ids_device(
        p, max_tokens=12, speculative=False, **kw),
    "device_exact": lambda g, p, **kw: g.generate_ids_device(
        p, max_tokens=12, speculative=False, bucket_lengths=False, **kw),
    "device_default_is_speculative": lambda g, p, **kw: g.generate_ids_device(
        p, max_tokens=12),
    "batch": lambda g, p, **kw: g.generate_batch_device(
        [p, p[:7], p[:20]], max_tokens=12, **kw),
}
PENALTIES = dict(repeat_penalty=1.3, frequency_penalty=0.2,
                 presence_penalty=0.1)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_streams_equal(pair, prompt, route):
    jgen, tgen = pair
    want = ROUTES[route](jgen, prompt)
    got = ROUTES[route](tgen, prompt)
    assert got == want
    assert want and all(want if route == "batch" else [want])


@pytest.mark.parametrize("route", ["device", "device_exact", "batch"])
def test_greedy_streams_equal_with_penalties(pair, prompt, route):
    jgen, tgen = pair
    want = ROUTES[route](jgen, prompt, **PENALTIES)
    got = ROUTES[route](tgen, prompt, **PENALTIES)
    assert got == want
    assert want != ROUTES[route](tgen, prompt)  # the penalties bite


def test_all_greedy_routes_agree(pair, prompt):
    _, tgen = pair
    host = ROUTES["host"](tgen, prompt)
    assert ROUTES["device"](tgen, prompt) == host
    assert ROUTES["device_exact"](tgen, prompt) == host
    assert ROUTES["batch"](tgen, prompt)[0] == host
    assert tgen.generate_ids_spec(prompt, max_tokens=12) == host


@pytest.mark.parametrize("draft_len,ngram", [(7, 3), (3, 2)])
def test_speculative_stream_and_stats_equal(pair, prompt, draft_len, ngram):
    jgen, tgen = pair
    want = jgen.generate_ids_spec(prompt, max_tokens=20, draft_len=draft_len,
                                  ngram=ngram)
    got = tgen.generate_ids_spec(prompt, max_tokens=20, draft_len=draft_len,
                                 ngram=ngram)
    assert got == want
    assert tgen.last_spec_stats == jgen.last_spec_stats
    assert tgen.last_spec_stats["forwards"] <= tgen.last_spec_stats["tokens"]


@pytest.mark.parametrize("route", ["host", "device", "batch", "spec"])
def test_early_eos(pair, prompt, route):
    """An EOS inside the greedy stream stops every route at the same token."""
    jgen, tgen = pair
    stream = tgen.generate_ids(prompt, max_tokens=12)
    _JEos.eos_id = _TEos.eos_id = stream[4]
    jtok, ttok = jgen.tokenizer, tgen.tokenizer
    jgen.tokenizer, tgen.tokenizer = _JEos(), _TEos()
    # the JAX package bakes the EOS id into its compiled loops
    cached, jgen._prefill_cache = jgen._prefill_cache, {}
    try:
        if route == "spec":
            want = jgen.generate_ids_spec(prompt, max_tokens=12)
            got = tgen.generate_ids_spec(prompt, max_tokens=12)
        else:
            want = ROUTES[route](jgen, prompt)
            got = ROUTES[route](tgen, prompt)
    finally:
        jgen.tokenizer, tgen.tokenizer = jtok, ttok
        jgen._prefill_cache = cached
    assert got == want
    first = got[0] if route == "batch" else got
    assert first == stream[:stream.index(stream[4])]


@pytest.mark.parametrize("route", ["host", "batch", "spec"])
def test_prompt_clipped_to_max_len(pair, route):
    jgen, tgen = pair
    long_prompt = jg.ByteTokenizer().encode(PROMPT * 6)
    assert len(long_prompt) > MAX_LEN
    if route == "spec":
        # the cache ends before max_tokens are out: both stop at its end
        want = jgen.generate_ids_spec(long_prompt, max_tokens=40)
        got = tgen.generate_ids_spec(long_prompt, max_tokens=40)
        assert tgen.last_spec_stats == jgen.last_spec_stats
    elif route == "batch":
        want = jgen.generate_batch_device([long_prompt, long_prompt[:9]],
                                          max_tokens=40)
        got = tgen.generate_batch_device([long_prompt, long_prompt[:9]],
                                         max_tokens=40)
    else:
        want = jgen.generate_ids(long_prompt, max_tokens=40)
        got = tgen.generate_ids(long_prompt, max_tokens=40)
    assert got == want


def _equal_or_near_tie(tgen, prompt, got, want):
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    ids = torch.tensor([list(prompt) + list(want[:i])])
    with torch.no_grad():
        top = torch.topk(tgen.model(ids)[0, -1], 2).values
    assert float(top[0] - top[1]) < NEAR_TIE, (i, got, want)


@pytest.mark.parametrize("kw", [
    dict(quantize=True), dict(quantize=True, fuse_projections=True),
    dict(quantize_kv=True), dict(fuse_projections=True),
], ids=["int8", "int8_fused", "int8_kv", "fused"])
def test_serving_transforms_greedy(prompt, kw):
    params = jd.LlamaDecoder(jd.DecoderConfig.tiny()).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(), params=params,
                            max_len=MAX_LEN, **kw)
    tgen = tg.TextGenerator(td.DecoderConfig.tiny(), params=_np_tree(params),
                            max_len=MAX_LEN, device="cpu", **kw)
    assert tgen.config.quantized_weights == jgen.config.quantized_weights
    assert tgen.config.fused_projections == jgen.config.fused_projections
    assert tgen.config.kv_cache_dtype == jgen.config.kv_cache_dtype
    want = jgen.generate_ids_device(prompt, max_tokens=10, speculative=False)
    got = tgen.generate_ids_device(prompt, max_tokens=10, speculative=False)
    if "quantize" in kw or "quantize_kv" in kw:
        _equal_or_near_tie(tgen, prompt, got, want)
    else:
        assert got == want
    assert tgen.generate_ids_spec(prompt, max_tokens=10) == tgen.generate_ids(
        prompt, max_tokens=10) or "quantize_kv" in kw


@pytest.mark.parametrize("length", [3, 64, 90])
def test_recent_window_equal(rng, length):
    ids = rng.integers(0, 500, size=(96,)).astype(np.int32)
    want = np.asarray(jg._recent_window(jnp.asarray(ids), jnp.int32(length), 512))
    got = tg._recent_window(torch.tensor(ids).long(), length, 512)
    np.testing.assert_array_equal(got.numpy(), want)
    # batched, as the batch loop calls it
    both = tg._recent_window(torch.tensor(np.stack([ids, ids[::-1].copy()])).long(),
                             torch.tensor([length, 5]), 512)
    np.testing.assert_array_equal(both[0].numpy(), want)
    assert int((both[1] == 512).sum()) == 64 - 5


@pytest.mark.parametrize("pen", [(1.3, 0.2, 0.1), (1.0, 0.0, 0.0),
                                 (2.0, 0.0, 0.5)])
def test_penalize_equal(rng, pen):
    logits = rng.standard_normal((512,)).astype(np.float32) * 3
    recent = rng.integers(0, 40, size=(64,)).astype(np.int32)
    recent[:9] = 512  # the short-prompt sentinel is dropped
    want = np.asarray(jg._penalize(jnp.asarray(logits), jnp.asarray(recent),
                                   jnp.asarray(pen, jnp.float32)))
    got = tg._penalize(torch.tensor(logits), torch.tensor(recent), pen)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if pen == (1.0, 0.0, 0.0):
        np.testing.assert_array_equal(got.numpy(), logits)


@pytest.mark.parametrize("top_k,top_p,temperature", [
    (10, 0.7, 1.0), (40, 0.9, 0.5), (0, 0.6, 1.0), (5, 1.0, 2.0)])
def test_sampling_filter_matches_jax_draws(rng, top_k, top_p, temperature):
    """Every token the JAX sampler draws lies in the port's kept set, and
    every kept token with a fair share of the mass is drawn."""
    logits = (rng.standard_normal((60,)) * 2).astype(np.float32)
    masked, idx = tg._sampling_filter(torch.tensor(logits), temperature,
                                      top_p, top_k)
    keep = torch.isfinite(masked)
    kept = set(idx[keep].tolist())
    probs = torch.softmax(masked, -1)
    assert masked.shape[-1] == (top_k if top_k else 60)
    assert bool((masked[:-1] >= masked[1:]).all())  # descending
    draws = jax.vmap(lambda key: jg.TextGenerator._sample(
        jnp.asarray(logits), key, jnp.float32(temperature),
        jnp.float32(top_p), top_k=top_k))(
            jax.random.split(jax.random.PRNGKey(0), 400))
    drawn = set(np.asarray(draws).tolist())
    assert drawn <= kept
    assert {int(t) for t, p in zip(idx[keep], probs[keep]) if p > 0.03} <= drawn


def test_ties_go_to_the_lowest_token_id():
    logits = torch.zeros(50)
    logits[[7, 3, 30]] = 2.0
    assert int(tg.TextGenerator._sample(logits, None, 0.0, 0.9)) == 3
    assert int(jg.TextGenerator._sample(
        jnp.asarray(logits.numpy()), jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.float32(0.9))) == 3
    _, idx = tg._sampling_filter(logits, 1.0, 1.0, 3)
    assert idx.tolist() == [3, 7, 30]


def test_sampled_streams_follow_their_seed(pair, prompt):
    _, tgen = pair
    kw = dict(max_tokens=12, temperature=0.9, top_p=0.95)
    a = tgen.generate_ids(prompt, seed=1, **kw)
    assert a == tgen.generate_ids(prompt, seed=1, **kw)
    assert a != tgen.generate_ids(prompt, seed=2, **kw)
    b = tgen.generate_batch_device([prompt, prompt[:9]], seed=4, **kw)
    assert b == tgen.generate_batch_device([prompt, prompt[:9]], seed=4, **kw)
    c = tgen.generate_ids_device(prompt, seed=5, bucket_lengths=False,
                                 repeat_penalty=1.2, **kw)
    assert c == tgen.generate_ids_device(prompt, seed=5, bucket_lengths=False,
                                         repeat_penalty=1.2, **kw)
    assert all(0 <= t < 512 for t in a + b[0] + b[1] + c)


def test_embed_batch_equal(pair):
    jgen, tgen = pair
    tok = jg.ByteTokenizer()
    prompts = [tok.encode("دارو چیست؟"), tok.encode("a"), tok.encode(PROMPT * 2)]
    want = jgen.embed_batch(prompts)
    got = tgen.embed_batch(prompts)
    assert got.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tgen.embed_text(["a"]), got[1:2], atol=1e-6)
    assert tgen.embed_batch([]).shape == (0, 64)


def test_generate_text_and_stop(pair):
    jgen, tgen = pair
    want = jgen.generate_text("سلام", max_tokens=10)
    assert tgen.generate_text("سلام", max_tokens=10) == want
    if len(want) > 2:
        cut = tgen.generate_text("سلام", max_tokens=10, stop=[want[2:]])
        assert cut == jgen.generate_text("سلام", max_tokens=10, stop=[want[2:]])
        assert len(cut) < len(want)
    assert tgen.generate_batch_device([]) == []


# GGUF import is ported (tests/test_torch_gguf.py): a missing file raises
@pytest.mark.parametrize("make,exc,match", [
    # a mesh is ported (tests/test_torch_tp_decoder.py): a non-Mesh raises
    (lambda: tg.TextGenerator(td.DecoderConfig.tiny(), mesh=object(),
                              device="cpu"), TypeError, "Mesh"),
    (lambda: tg.TextGenerator.from_gguf("model.gguf", quantize="int4",
                                        device="cpu"),
     FileNotFoundError, "model.gguf"),
])
def test_leftovers_raise(make, exc, match):
    with pytest.raises(exc, match=match):
        make()
