"""models/decoder.py of the port against the JAX package: the same ids
(numpy, seeded) go through `LlamaDecoder.apply` on Flax-initialised
parameters and through the port's module on the converted tree
(`decoder_params_from_flax`), on the CPU (quantized Dense layers run the
kernels' plain versions on both sides).

Tolerances: f32 logits atol 2e-4 (different summation orders through two
or more layers); bf16 compared after upcast, atol 5e-2 (bf16 rounds at
other places in the two frameworks). Quantized weights take the bf16
tolerance even with f32 compute: every quantized Dense rounds its
activations to bf16, and a last-bit f32 difference upstream can flip such
a rounding (one step is 2^-9 of the value)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu_torch.models import decoder as td
from persian_rag_tpu_torch.models.convert import decoder_params_from_flax

# widths that reach the kernel route (N % 128 == 0) and DecoderConfig.tiny()
NARROW = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=512,
              max_position_embeddings=128, rope_theta=10_000.0)
TINY = {k: v for k, v in dataclasses.asdict(jd.DecoderConfig.tiny()).items()
        if k in NARROW}
SHAPES = {"narrow": NARROW, "tiny": TINY}
F32_ATOL, BF16_ATOL = 2e-4, 5e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(shape="narrow", bf16=False, quantized=False, fused=False,
          seed=0, **kw):
    """(JAX config, JAX params, port module) with the same weights."""
    fields = {**SHAPES[shape], **kw}
    base = jd.DecoderConfig(**fields)
    params = jd.LlamaDecoder(base).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    if fused:
        params = jd.fuse_params(params)
    if quantized:
        params = jd.quantize_decoder_params(params)
    jcfg = dataclasses.replace(
        base, fused_projections=fused, quantized_weights=quantized,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = td.DecoderConfig(
        **fields, fused_projections=fused, quantized_weights=quantized,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    tree = _np_tree(params)
    if bf16:
        params = jd.cast_params(params, jnp.bfloat16)
        tree = td.cast_params(tree, torch.bfloat16)
    with torch.device("meta"):
        model = td.LlamaDecoder(tcfg)
    model.load_state_dict(decoder_params_from_flax(tree, tcfg), assign=True)
    return jcfg, params, model.eval()


def _ids(rng, b, s, vocab=512):
    return rng.integers(1, vocab, size=(b, s)).astype(np.int32)


def _t(a):
    return torch.tensor(np.asarray(a)).long()


def _close(got, want, bf16=False):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0,
        atol=BF16_ATOL if bf16 else F32_ATOL)


VARIANTS = {
    "float": {}, "fused": {"fused": True}, "quantized": {"quantized": True},
    "quantized_fused": {"quantized": True, "fused": True},
    "untied": {"tie_word_embeddings": False},
    "untied_quantized": {"tie_word_embeddings": False, "quantized": True},
    "bf16": {"bf16": True}, "bf16_quantized": {"bf16": True, "quantized": True},
}


@pytest.mark.parametrize("shape", ["narrow", "tiny"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@torch.no_grad()
def test_full_forward(rng, shape, variant):
    kw = VARIANTS[variant]
    jcfg, params, model = _pair(shape, **kw)
    ids = _ids(rng, 2, 11)
    mask = np.ones((2, 11), np.int32)
    mask[1, 8:] = 0
    want = jd.LlamaDecoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = model(_t(ids), attention_mask=_t(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 11, 512)
    _close(got, want, kw.get("bf16", False) or kw.get("quantized", False))


@pytest.mark.parametrize("variant", ["float", "quantized", "bf16_quantized"])
@pytest.mark.parametrize("kv", ["compute", "int8"])
@torch.no_grad()
def test_prefill_and_decode_with_cache(rng, variant, kv):
    kw = VARIANTS[variant]
    bf16 = kw.get("bf16", False) or kw.get("quantized", False)
    jcfg, params, model = _pair("narrow", kv_cache_dtype=kv, **kw)
    ids = _ids(rng, 1, 9)
    jmodel = jd.LlamaDecoder(jcfg)
    jcache = jd.init_cache(jcfg, 1, 16)
    tcache = td.init_cache(model.config, 1, 16, device="cpu")
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name][0].shape) == jcache[name][0].shape
    pos = np.arange(6, dtype=np.int32)[None, :]
    want, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(ids[:, :6]), positions=jnp.asarray(pos),
        cache=jcache, cache_pos=jnp.int32(0))
    got, tcache = model(_t(ids[:, :6]), positions=_t(pos), cache=tcache,
                        cache_pos=0)
    _close(got, want, bf16)
    for step in range(6, 9):
        want, jcache = jmodel.apply(
            {"params": params}, jnp.asarray(ids[:, step:step + 1]),
            positions=jnp.full((1, 1), step, jnp.int32), cache=jcache,
            cache_pos=jnp.int32(step))
        got, tcache = model(_t(ids[:, step:step + 1]),
                            positions=_t([[step]]), cache=tcache, cache_pos=step)
        _close(got, want, bf16)
    if kv == "int8":
        np.testing.assert_allclose(
            tcache["k_scale"][0].numpy(), np.asarray(jcache["k_scale"][0]),
            rtol=1e-4, atol=1e-6)
        assert tcache["k"][0].dtype == torch.int8


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("quantized", [False, True])
@torch.no_grad()
def test_kv_valid(rng, ndim, quantized):
    """Cache slots decoupled from positions: a right-padded ragged prefill,
    then a block whose validity is per row (2-D) or per query (3-D)."""
    jcfg, params, model = _pair("narrow", quantized=quantized)
    jmodel = jd.LlamaDecoder(jcfg)
    b, bucket, cache_len, s = 2, 8, 16, 1 if ndim == 2 else 3
    ids = _ids(rng, b, bucket)
    lengths = np.asarray([8, 5], np.int32)
    key = np.arange(cache_len)[None, :]
    jcache = jd.init_cache(jcfg, b, cache_len)
    tcache = td.init_cache(model.config, b, cache_len, device="cpu")
    pos = np.broadcast_to(np.arange(bucket, dtype=np.int32), (b, bucket))
    mask = (key < lengths[:, None]).astype(np.int32)
    _, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(ids), positions=jnp.asarray(pos),
        attention_mask=jnp.asarray(mask), cache=jcache, cache_pos=jnp.int32(0))
    model(_t(ids), positions=_t(pos), attention_mask=_t(mask), cache=tcache,
          cache_pos=0)
    block = _ids(rng, b, s)
    bpos = lengths[:, None] + np.arange(s, dtype=np.int32)[None, :]
    if ndim == 2:
        valid = (key < lengths[:, None]) | ((key >= bucket) & (key <= bucket))
    else:
        slots = bucket + np.arange(s)
        valid = (key[:, None, :] < lengths[:, None, None]) | (
            (key[:, None, :] >= bucket) & (key[:, None, :] <= slots[None, :, None]))
    want, _ = jmodel.apply(
        {"params": params}, jnp.asarray(block), positions=jnp.asarray(bpos),
        cache=jcache, cache_pos=jnp.int32(bucket), kv_valid=jnp.asarray(valid))
    got, _ = model(_t(block), positions=_t(bpos), cache=tcache,
                   cache_pos=bucket, kv_valid=torch.tensor(valid))
    _close(got, want, quantized)


@torch.no_grad()
def test_per_row_cache_slots_drop_out_of_bounds(rng):
    jcfg, params, model = _pair("tiny", kv_cache_dtype="int8")
    jmodel = jd.LlamaDecoder(jcfg)
    b, cache_len, s = 3, 12, 2
    block = _ids(rng, b, s)
    starts = np.asarray([0, 5, 11], np.int32)  # row 2's second slot is past the end
    pos = starts[:, None] + np.arange(s, dtype=np.int32)[None, :]
    valid = np.arange(cache_len)[None, None, :] <= pos[:, :, None]
    jcache = jd.init_cache(jcfg, b, cache_len)
    tcache = td.init_cache(model.config, b, cache_len, device="cpu")
    want, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(block), positions=jnp.asarray(pos),
        cache=jcache, cache_pos=jnp.asarray(starts), kv_valid=jnp.asarray(valid))
    got, tcache = model(_t(block), positions=_t(pos), cache=tcache,
                        cache_pos=_t(starts), kv_valid=torch.tensor(valid))
    _close(got, want)
    np.testing.assert_array_equal(
        tcache["k"][1].numpy(), np.asarray(jcache["k"][1]))


@torch.no_grad()
def test_scalar_slot_is_moved_back_at_the_cache_end(rng):
    """dynamic_update_slice clamps the start so that the block fits."""
    jcfg, params, model = _pair("tiny")
    block = _ids(rng, 1, 3)
    pos = np.asarray([[9, 10, 11]], np.int32)
    valid = np.ones((1, 12), bool)
    jcache = jd.init_cache(jcfg, 1, 12)
    tcache = td.init_cache(model.config, 1, 12, device="cpu")
    _, jcache = jd.LlamaDecoder(jcfg).apply(
        {"params": params}, jnp.asarray(block), positions=jnp.asarray(pos),
        cache=jcache, cache_pos=jnp.int32(11), kv_valid=jnp.asarray(valid))
    model(_t(block), positions=_t(pos), cache=tcache, cache_pos=11,
          kv_valid=torch.tensor(valid))
    np.testing.assert_allclose(
        tcache["v"][0].numpy(), np.asarray(jcache["v"][0]), atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@torch.no_grad()
def test_return_hidden_and_last_positions(rng, quantized):
    jcfg, params, model = _pair("narrow", quantized=quantized)
    ids = _ids(rng, 2, 7)
    want = jd.LlamaDecoder(jcfg).apply(
        {"params": params}, jnp.asarray(ids), return_hidden=True)
    got = model(_t(ids), return_hidden=True)
    assert got.shape == (2, 7, 256)
    _close(got, want, quantized)
    # one position per row before the lm_head: the same rows of the logits
    full = model(_t(ids))
    last = _t([6, 2])
    one = model(_t(ids), last_positions=last)
    assert one.shape == (2, 1, 512)
    np.testing.assert_allclose(
        one[:, 0].numpy(), full[torch.arange(2), last].numpy(), atol=1e-5)


def test_rope_and_kv_quantization_equal_jax(rng):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        td._rope(torch.tensor(x), _t(pos), 10_000.0).numpy(),
        np.asarray(jd._rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        atol=1e-5)
    x[0, 1, 2] = 0.0  # an all-zero vector: values 0, scale 0, no NaN
    jv, js = jd._quantize_kv(jnp.asarray(x))
    tv, ts = td._quantize_kv(torch.tensor(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)


def _same_layout(ttree, jtree, values=True):
    assert set(ttree) == set(jtree)
    for name, sub in jtree.items():
        if isinstance(sub, dict):
            _same_layout(ttree[name], sub, values)
            continue
        got = torch.as_tensor(ttree[name])
        want = np.asarray(sub.astype(jnp.float32)
                          if sub.dtype == jnp.bfloat16 else sub)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).replace("torch.", "") == str(sub.dtype), name
        if values:
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))


def _flax_params(shape="tiny", **kw):
    cfg = jd.DecoderConfig(**{**SHAPES[shape], **kw})
    return cfg, jd.LlamaDecoder(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]


def test_fuse_cast_quantize_layouts_equal_jax():
    _, params = _flax_params("narrow")
    tree = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params)
    _same_layout(td.fuse_params(tree), jd.fuse_params(params))
    _same_layout(td.cast_params(tree, torch.bfloat16),
                 jd.cast_params(params, jnp.bfloat16))
    jq = jd.quantize_decoder_params(jd.fuse_params(params))
    tq = td.quantize_decoder_params(td.fuse_params(tree))
    _same_layout(tq, jq)
    # a quantized tree survives the serving cast untouched
    _same_layout(td.cast_params(tq, torch.bfloat16),
                 jd.cast_params(jq, jnp.bfloat16))


@pytest.mark.parametrize("tied", [True, False])
def test_random_quantized_params_layout_equals_jax(tied):
    kw = {**TINY, "tie_word_embeddings": tied}
    jtree = jd.random_quantized_params(
        jd.DecoderConfig(**kw, compute_dtype=jnp.bfloat16), seed=3)
    ttree = td.random_quantized_params(
        td.DecoderConfig(**kw, compute_dtype=torch.bfloat16), seed=3,
        device="cpu")
    _same_layout(ttree, jtree, values=False)
    # the scales are the same constants, the values fill the int8 range
    np.testing.assert_allclose(
        ttree["layer_0"]["mlp"]["down_proj"]["scale"].numpy(),
        np.asarray(jtree["layer_0"]["mlp"]["down_proj"]["scale"]), rtol=1e-6)
    v = ttree["embed_tokens"]["values"]
    assert int(v.min()) == -127 and int(v.max()) == 127
    again = td.random_quantized_params(
        td.DecoderConfig(**kw, compute_dtype=torch.bfloat16), seed=3,
        device="cpu")
    assert torch.equal(again["embed_tokens"]["values"], v)


def test_params_from_llama_equals_jax(rng):
    cfg = td.DecoderConfig(**{**TINY, "tie_word_embeddings": False})
    h, kv, f, v = 64, 32, 128, 512
    sd = {"model.embed_tokens.weight": rng.standard_normal((v, h)),
          "model.norm.weight": rng.standard_normal((h,)),
          "lm_head.weight": rng.standard_normal((v, h))}
    for i in range(2):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = rng.standard_normal((h,))
        sd[f"{p}.post_attention_layernorm.weight"] = rng.standard_normal((h,))
        for name, shape in (("q_proj", (h, h)), ("k_proj", (kv, h)),
                            ("v_proj", (kv, h)), ("o_proj", (h, h))):
            sd[f"{p}.self_attn.{name}.weight"] = rng.standard_normal(shape)
        for name, shape in (("gate_proj", (f, h)), ("up_proj", (f, h)),
                            ("down_proj", (h, f))):
            sd[f"{p}.mlp.{name}.weight"] = rng.standard_normal(shape)
    sd = {k: a.astype(np.float32) for k, a in sd.items()}
    jtree = jd.params_from_llama(
        sd, jd.DecoderConfig(**{**TINY, "tie_word_embeddings": False}))
    ttree = td.params_from_llama({k: torch.tensor(a) for k, a in sd.items()}, cfg)
    _same_layout(ttree, jax.tree_util.tree_map(jnp.asarray, jtree))
    state = decoder_params_from_flax(ttree, cfg)
    assert "layers.1.mlp.down_proj.kernel" in state and "lm_head.kernel" in state


@pytest.mark.parametrize("preset", ["llama32_1b", "llama32_3b", "llama31_8b",
                                    "tiny", "from_hf"])
def test_config_presets_equal_jax(preset):
    args = ()
    if preset == "from_hf":
        args = ({"vocab_size": 1000, "hidden_size": 128,
                 "num_hidden_layers": 3, "num_attention_heads": 8,
                 "intermediate_size": 256, "rope_theta": 1e4},)
    want = dataclasses.asdict(getattr(jd.DecoderConfig, preset)(*args))
    got = dataclasses.asdict(getattr(td.DecoderConfig, preset)(*args))
    for name in ("compute_dtype", "quantized_backend"):
        want.pop(name, None)
        got.pop(name, None)
    assert got == want


def test_layout_mismatch_and_int4_raise():
    _, params = _flax_params("tiny")
    tree = _np_tree(params)
    with pytest.raises(ValueError, match="quantized=False"):
        decoder_params_from_flax(
            tree, td.DecoderConfig(**TINY, quantized_weights=True))
    # int4 is ported: a packed tree loads into an int4 config only, and
    # other widths than int8 / int4 raise
    int4 = td.quantize_decoder_params(tree, bits=4)
    decoder_params_from_flax(
        int4, td.DecoderConfig(**TINY, quantized_weights=True,
                               quantized_bits=4))
    with pytest.raises(ValueError, match="bits=4"):
        decoder_params_from_flax(
            int4, td.DecoderConfig(**TINY, quantized_weights=True))
    with pytest.raises(ValueError, match="int8 or int4"):
        td.LlamaDecoder(td.DecoderConfig(**TINY, quantized_weights=True,
                                         quantized_bits=3))
    with pytest.raises(ValueError, match="int8 or int4"):
        td.quantize_decoder_params({}, bits=3)
