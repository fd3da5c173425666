"""int4 weights in models/decoder.py and gen/generator.py of the port against
the JAX package: Flax-initialised parameters quantized to int4 by the JAX
package (`quantize_decoder_params(bits=4)`) go through `LlamaDecoder.apply`
with ``quantized_bits=4`` and, converted, through the port's module, on the
CPU (the w4a16 products run the kernel's plain version on both sides).

Tolerance: quantized weights round their activations to bf16, so logits
take the bf16 tolerance, atol 5e-2, even with f32 compute (a last-bit f32
difference upstream can flip such a rounding). Greedy streams are equal or
first part at a step whose top-2 logit gap is under 5e-2."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu_torch.gen import generator as tg
from persian_rag_tpu_torch.models import decoder as td
from persian_rag_tpu_torch.models.convert import decoder_params_from_flax
from persian_rag_tpu_torch.ops.quant_matmul import unpack_int4

NARROW = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=512,
              max_position_embeddings=128, rope_theta=10_000.0)
ATOL = 5e-2
NEAR_TIE = 5e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax(seed=0, **kw):
    cfg = jd.DecoderConfig(**{**NARROW, **kw})
    return cfg, jd.LlamaDecoder(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]


def _pair(fused=False, bf16=False, **kw):
    """(JAX module, JAX int4 params, port module) with the same weights."""
    base, params = _flax(**kw)
    if fused:
        params = jd.fuse_params(params)
    dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                          torch.float32)
    # numpy has no bf16: a bf16 tree is cast and packed on each side, an f32
    # one is packed by the JAX package and loaded as it is
    tree = td.quantize_decoder_params(
        td.cast_params(_np_tree(params), dtype[1]), bits=4)
    params = jd.quantize_decoder_params(jd.cast_params(params, dtype[0]),
                                        bits=4)
    if not bf16:
        tree = _np_tree(params)
    jcfg = dataclasses.replace(base, fused_projections=fused,
                               quantized_weights=True, quantized_bits=4,
                               compute_dtype=dtype[0])
    tcfg = td.DecoderConfig(**{**NARROW, **kw}, fused_projections=fused,
                            quantized_weights=True, quantized_bits=4,
                            compute_dtype=dtype[1])
    with torch.device("meta"):
        model = td.LlamaDecoder(tcfg)
    model.load_state_dict(decoder_params_from_flax(tree, tcfg), assign=True)
    return jd.LlamaDecoder(jcfg), params, model.eval()


VARIANTS = {
    "int4": {}, "int4_fused": {"fused": True}, "int4_bf16": {"bf16": True},
    "int4_untied": {"tie_word_embeddings": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@torch.no_grad()
def test_int4_logits(rng, variant):
    jmodel, params, model = _pair(**VARIANTS[variant])
    ids = rng.integers(1, 512, size=(2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[1, 8:] = 0
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask))
    got = model(torch.tensor(ids).long(), attention_mask=torch.tensor(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 11, 512)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=ATOL)


@torch.no_grad()
def test_int4_prefill_and_per_row_decode(rng):
    """A prefill into the cache, then a step at per-row cache slots."""
    jmodel, params, model = _pair()
    b, cache_len = 2, 16
    ids = rng.integers(1, 512, size=(b, 6)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (b, 6))
    jcache = jd.init_cache(jmodel.config, b, cache_len)
    tcache = td.init_cache(model.config, b, cache_len, device="cpu")
    want, jcache = jmodel.apply({"params": params}, jnp.asarray(ids),
                                positions=jnp.asarray(pos), cache=jcache,
                                cache_pos=jnp.int32(0))
    got, tcache = model(torch.tensor(ids).long(), positions=torch.tensor(pos),
                        cache=tcache, cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    slots = np.asarray([6, cache_len], np.int32)  # row 1 parked: dropped
    tok = rng.integers(1, 512, size=(b, 1)).astype(np.int32)
    valid = np.arange(cache_len)[None, :] <= np.minimum(slots, 6)[:, None]
    want, _ = jmodel.apply({"params": params}, jnp.asarray(tok),
                           positions=jnp.full((b, 1), 6, jnp.int32),
                           cache=jcache, cache_pos=jnp.asarray(slots),
                           kv_valid=jnp.asarray(valid))
    got, tcache = model(torch.tensor(tok).long(),
                        positions=torch.full((b, 1), 6), cache=tcache,
                        cache_pos=torch.tensor(slots).long(),
                        kv_valid=torch.tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_fuse_params_on_packed_trees():
    """Fusing a packed int4 tree equals packing the fused float tree: a
    packed byte holds two rows of one column, so columns concatenate."""
    _, params = _flax()
    tree = td.cast_params(_np_tree(params), torch.float32)
    a = td.fuse_params(td.quantize_decoder_params(tree, bits=4))
    b = td.quantize_decoder_params(td.fuse_params(tree), bits=4)
    for proj in (("attention", "qkv_proj"), ("mlp", "gateup_proj")):
        for leaf in ("values", "scale"):
            x = a["layer_1"][proj[0]][proj[1]][leaf]
            assert torch.equal(x, b["layer_1"][proj[0]][proj[1]][leaf])
    assert a["layer_0"]["attention"]["qkv_proj"]["values"].shape == (128, 512)
    jfused = jd.quantize_decoder_params(jd.fuse_params(params), bits=4)
    np.testing.assert_array_equal(
        a["layer_0"]["mlp"]["gateup_proj"]["values"].numpy(),
        np.asarray(jfused["layer_0"]["mlp"]["gateup_proj"]["values"]))


def test_untied_lm_head_stays_int8():
    _, params = _flax(tie_word_embeddings=False)
    tree = td.quantize_decoder_params(_np_tree(params), bits=4)
    jtree = jd.quantize_decoder_params(params, bits=4)
    assert tree["lm_head"]["values"].shape == (256, 512)
    np.testing.assert_array_equal(tree["lm_head"]["values"].numpy(),
                                  np.asarray(jtree["lm_head"]["values"]))
    assert tree["layer_0"]["mlp"]["down_proj"]["values"].shape == (256, 256)
    cfg = td.DecoderConfig(**NARROW, tie_word_embeddings=False,
                           quantized_weights=True, quantized_bits=4)
    model = td.LlamaDecoder(cfg)
    assert model.lm_head.bits == 8 and model.layers[0].mlp.down_proj.bits == 4
    rand = td.random_quantized_params(cfg, device="cpu")
    assert rand["lm_head"]["values"].shape == (256, 512)
    assert float(rand["lm_head"]["scale"][0, 0]) == pytest.approx(
        1.0 / (73.6 * np.sqrt(256)))


@pytest.mark.parametrize("tied", [True, False])
def test_random_quantized_params_int4_layout(tied):
    """Shapes, dtypes and scales of every leaf equal the JAX package's (the
    random bytes differ: other generators); the packed nibbles cover
    [-8, 7]."""
    kw = dict(NARROW, tie_word_embeddings=tied)
    jtree = jd.random_quantized_params(jd.DecoderConfig(**kw), seed=0, bits=4)
    ttree = td.random_quantized_params(td.DecoderConfig(**kw), seed=0,
                                       bits=4, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(ttree)[0])
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        got = tflat[path]
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
        if path[-1].key == "scale":
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(leaf, np.float32), rtol=1e-6)
    lo, hi = unpack_int4(ttree["layer_0"]["mlp"]["down_proj"]["values"])
    assert int(torch.minimum(lo, hi).min()) == -8
    assert int(torch.maximum(lo, hi).max()) == 7


def _equal_or_near_tie(tgen, prompt, got, want):
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    ids = torch.tensor([list(prompt) + list(want[:i])])
    with torch.no_grad():
        top = torch.topk(tgen.model(ids)[0, -1], 2).values
    assert float(top[0] - top[1]) < NEAR_TIE, (i, got, want)


@pytest.mark.parametrize("fuse", [False, True], ids=["int4", "int4_fused"])
def test_generator_int4_greedy(fuse):
    """TextGenerator(quantize="int4") quantizes a float tree as the JAX
    generator does; greedy streams agree."""
    params = jd.LlamaDecoder(jd.DecoderConfig.tiny()).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(), params=params,
                            max_len=96, quantize="int4",
                            fuse_projections=fuse)
    tgen = tg.TextGenerator(td.DecoderConfig.tiny(), params=_np_tree(params),
                            max_len=96, quantize="int4", device="cpu",
                            fuse_projections=fuse)
    assert (tgen.config.quantized_weights, tgen.config.quantized_bits) == (
        True, 4)
    assert tgen.model.layers[0].attention.o_proj.values.shape == (32, 64)
    np.testing.assert_array_equal(
        tgen.params["layer_0"]["attention"]["o_proj"]["values"].numpy(),
        np.asarray(jgen.params["layer_0"]["attention"]["o_proj"]["values"]))
    prompt = jg.ByteTokenizer().encode("دارو چیست؟ دارو چیست؟ دارو")
    want = jgen.generate_ids_device(prompt, max_tokens=10, speculative=False)
    got = tgen.generate_ids_device(prompt, max_tokens=10, speculative=False)
    _equal_or_near_tie(tgen, prompt, got, want)
    assert tgen.generate_ids_spec(prompt, max_tokens=10) == tgen.generate_ids(
        prompt, max_tokens=10)
