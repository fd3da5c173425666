"""parallel/tp_decoder.py and TextGenerator(mesh=) of the port against the
JAX package's decoder, on the CPU.

The same Flax-initialised weights serve through the JAX decoder and
through the port's tensor-parallel decoder on meshes of repeated CPU
devices. Tolerances: f32 TP logits within 2e-5 of the port's
single-device forward (the JAX TP tests' own limit) and within the
cross-framework F32_ATOL (tests/test_torch_decoder.py) of the JAX forward
on its TP placement; quantized weights round activations to bf16, so
their logits take BF16_ATOL; greedy token streams EQUAL to the JAX
generator's and to the port's single-device ones, on every loop.
Placement: the port splits the attention block on whole (query, kv) head
groups only (a kv-head count the axis does not divide keeps it whole,
where the JAX placement cuts mid-head), and int4 row-parallel shards are
repacked from the K-slices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.core.mesh import build_mesh as jbuild
from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu.parallel.tp_decoder import shard_decoder_params_tp
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.gen import generator as tg
from persian_rag_tpu_torch.gen.continuous import ContinuousBatcher
from persian_rag_tpu_torch.models import decoder as td
from persian_rag_tpu_torch.ops import quant_matmul as qm
from persian_rag_tpu_torch.parallel import tp_decoder as ttp

from test_torch_decoder import BF16_ATOL, F32_ATOL

BASE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=8,
            num_kv_heads=8, intermediate_size=256,
            max_position_embeddings=128, rope_theta=10_000.0)
CONFIGS = {
    "divisible": BASE,
    # Llama-1B-like heads: 2 kv heads do not split 8 ways (the JAX
    # placement cuts each kv head in 4)
    "mid_head": dict(BASE, num_layers=1, num_kv_heads=2),
    # a vocabulary of 510 stays whole
    "indivisible": dict(BASE, num_layers=1, vocab_size=510),
}
PROMPTS = [list(np.random.default_rng(7).integers(1, 250, 9)),
           list(np.random.default_rng(8).integers(1, 250, 21)),
           list(np.random.default_rng(9).integers(1, 250, 4))]


def _meshes(n):
    return (jbuild(n, 1, devices=jax.devices()[:n]),
            build_mesh(n, 1, devices=["cpu"] * n))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, fields in CONFIGS.items():
        params = jd.LlamaDecoder(jd.DecoderConfig(**fields)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        out[name] = (params, jax.tree_util.tree_map(np.asarray, params))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("n", [2, 8])
def test_tp_forward_equals_single_and_jax(trees, name, n):
    params, tree = trees[name]
    cfg = td.DecoderConfig(**CONFIGS[name])
    jm, tm = _meshes(n)
    ids = np.array(jax.random.randint(jax.random.PRNGKey(3), (2, 12), 0,
                                      CONFIGS[name]["vocab_size"]))
    single = tg.TextGenerator(cfg, params=tree, device="cpu")
    tp = tg.TextGenerator(cfg, params=tree, mesh=tm)
    assert isinstance(tp.model, ttp.TPLlamaDecoder)
    with torch.no_grad():
        want = single.model(torch.as_tensor(ids)).numpy()
        got = tp.model(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    jmodel = jd.LlamaDecoder(jd.DecoderConfig(**CONFIGS[name]))
    jtp = shard_decoder_params_tp(params, jm, axis="corpus")
    jlogits = np.asarray(jmodel.apply({"params": jtp}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, jlogits, rtol=0, atol=F32_ATOL)
    # placement: whole head groups, the MLP and the vocabulary by width
    plan = ttp.split_plan(cfg, n)
    q = tp.model.attn[0][0].block.q_proj.kernel
    assert q.shape[1] == (cfg.hidden_size // n if plan["attention"]
                          else cfg.hidden_size)
    assert len(tp.model.attn[0]) == (n if plan["attention"] else 1)
    assert len(tp.model.mlp[0]) == n  # 256 divides 2 and 8
    assert len(tp.model.embed) == (n if cfg.vocab_size % n == 0 else 1)


def test_tp_generation_streams_equal_jax(trees):
    params, tree = trees["divisible"]
    jgen = jg.TextGenerator(jd.DecoderConfig(**BASE), params=params,
                            max_len=64)
    _, tm = _meshes(8)
    tp = tg.TextGenerator(td.DecoderConfig(**BASE), params=tree, max_len=64,
                          mesh=tm)
    assert tp.generate_batch_device(PROMPTS, max_tokens=8) == \
        jgen.generate_batch_device(PROMPTS, max_tokens=8)
    assert tp.generate_ids_device(PROMPTS[0], max_tokens=8) == \
        jgen.generate_ids_device(PROMPTS[0], max_tokens=8)
    assert tp.generate_ids(PROMPTS[1], max_tokens=8) == \
        jgen.generate_ids(PROMPTS[1], max_tokens=8)


@pytest.mark.parametrize("quantize,kv", [("int8", False), ("int8", True),
                                         ("int4", False)])
@pytest.mark.parametrize("n", [2, 8])
def test_quantized_tp_equals_single(trees, quantize, kv, n):
    """int8 / int4 weights (and an int8 KV cache) split over the mesh:
    logits within BF16_ATOL and greedy streams equal to the single-device
    quantized generator's, which tests/test_torch_generator.py and
    test_torch_decoder_int4.py hold to the JAX one."""
    _, tree = trees["divisible"]
    cfg = td.DecoderConfig(**BASE)
    _, tm = _meshes(n)
    kw = dict(params=tree, max_len=64, quantize=quantize, quantize_kv=kv)
    single = tg.TextGenerator(cfg, device="cpu", **kw)
    tp = tg.TextGenerator(cfg, mesh=tm, **kw)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (2, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(tp.model(ids).numpy(),
                                   single.model(ids).numpy(), rtol=0,
                                   atol=BF16_ATOL)
    assert tp.generate_batch_device(PROMPTS, max_tokens=8) == \
        single.generate_batch_device(PROMPTS, max_tokens=8)
    down = tp.model.mlp[0][0].block.down_proj.dense
    assert down.values.shape[0] == (256 // n // 2 if quantize == "int4"
                                    else 256 // n)
    if kv:
        assert "k_scale" in tp.new_cache(1, 8)["parts"][0]
    if quantize == "int8" and not kv and n == 8:
        jgen = jg.TextGenerator(jd.DecoderConfig(**BASE),
                                params=trees["divisible"][0], max_len=64,
                                quantize=True)
        assert tp.generate_batch_device(PROMPTS, max_tokens=8) == \
            jgen.generate_batch_device(PROMPTS, max_tokens=8)


def test_int4_row_split_repacks_the_k_slices():
    w = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    packed, scale = qm.quantize_weight_int4(w)
    lo, hi = qm.unpack_int4(packed)
    full = torch.cat([lo, hi])  # (K, N) nibble values
    for n in (2, 4):
        for part, want in zip(ttp.split_int4_rows(packed, n),
                              torch.chunk(full, n)):
            plo, phi = qm.unpack_int4(part)
            assert torch.equal(torch.cat([plo, phi]), want)
        x = torch.randn(3, 64, generator=torch.Generator().manual_seed(1))
        total = sum(qm.w4a16_matmul(xs, part, scale) for xs, part in zip(
            torch.chunk(x, n, dim=1), ttp.split_int4_rows(packed, n)))
        np.testing.assert_allclose(total.numpy(),
                                   qm.w4a16_matmul(x, packed, scale).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_continuous_batcher_over_tp_equals_single(trees):
    _, tree = trees["divisible"]
    cfg = td.DecoderConfig(**BASE)
    _, tm = _meshes(2)
    streams = []
    for kw in (dict(device="cpu"), dict(mesh=tm)):
        gen = tg.TextGenerator(cfg, params=tree, max_len=64, **kw)
        batcher = ContinuousBatcher(gen, batch=2, segment=4)
        for p in PROMPTS:
            batcher.submit(p, max_tokens=6)
        streams.append({r.req_id: r.tokens
                        for r in batcher.run_until_drained()})
    assert streams[0] == streams[1]


def test_fused_projections_are_not_served_on_a_mesh(trees):
    _, tree = trees["divisible"]
    _, tm = _meshes(2)
    fused = dataclasses.replace(td.DecoderConfig(**BASE),
                                fused_projections=True)
    with pytest.raises(ValueError, match="unfused"):
        tg.TextGenerator(fused, mesh=tm)
    # fuse_projections is a single-device transform, ignored on a mesh
    gen = tg.TextGenerator(td.DecoderConfig(**BASE), params=tree, mesh=tm,
                           fuse_projections=True)
    assert not gen.config.fused_projections
    with pytest.raises(TypeError, match="Mesh"):
        tg.TextGenerator(td.DecoderConfig(**BASE), mesh=object())
