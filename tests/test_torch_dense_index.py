"""The port's DenseIndex (f32 tier) against the JAX package's, on the CPU.

Below TWO_STAGE_MIN_N both serve the materialized f32 scan. At 32,768
rows the port runs the two-stage regime through the kernels' plain
version while the JAX package, off the TPU, serves its materialized scan:
the ids agree by the residual proof.
"""
import importlib

import numpy as np
import pytest
import torch

from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.index.dense import DenseIndex

tft = importlib.import_module("persian_rag_tpu_torch.ops.flat_topk")


def _pair(metric, corpus):
    j = JaxDenseIndex(corpus.shape[1], metric=metric)
    j.add(corpus)
    j.commit()
    t = DenseIndex(corpus.shape[1], metric=metric, device="cpu")
    t.add(corpus)
    t.commit()
    return j, t


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_small_index_matches_jax(rng, metric):
    corpus = rng.standard_normal((700, 48)).astype(np.float32)
    queries = rng.standard_normal((9, 48)).astype(np.float32)
    j, t = _pair(metric, corpus)
    want_s, want_i = j.search(queries, 7)
    got_s, got_i = t.search(queries, 7)
    assert isinstance(got_s, torch.Tensor) and isinstance(got_i, torch.Tensor)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-4)
    # one 1-D query, k above ntotal, rows / vectors round trips
    s1, i1 = t.search(queries[0], 5)
    np.testing.assert_array_equal(i1.numpy(), want_i[0, :5])
    assert t.search(queries, 5000)[1].shape == (9, 700)
    np.testing.assert_array_equal(t.rows([5, 3]), j.rows(np.array([5, 3])))
    np.testing.assert_array_equal(t.vectors(), j.vectors())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("stage1", [None, "bf16x2"])
def test_two_stage_index_matches_jax(rng, monkeypatch, metric, stage1):
    n, d = tft.TWO_STAGE_MIN_N, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[rng.integers(0, n, 12)] + 0.1 * rng.standard_normal(
        (12, d)).astype(np.float32)
    calls = []
    e2s = tft.flat_topk_exact2_stream
    monkeypatch.setattr(
        tft, "flat_topk_exact2_stream",
        lambda *a, **kw: calls.append(kw) or e2s(*a, **kw),
    )
    j, t = _pair(metric, corpus)
    assert t._stage1_mode == "bf16"  # the probe's pick at these margins
    if stage1:
        t._set_stage1_mode(stage1)
    assert (t._stage1_lo is not None) == (stage1 == "bf16x2")
    want_s, want_i = j.search(queries, 10)
    got_s, got_i = t.search(queries, 10)
    assert len(calls) == 1  # the two-stage regime served the port
    assert (calls[0]["corpus_bf16_lo"] is not None) == (stage1 == "bf16x2")
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    assert t._fail_streak == 0


def test_commit_caches_match_jax(rng):
    n, d = tft.TWO_STAGE_MIN_N, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    j, t = _pair("l2", corpus)
    t._set_stage1_mode("bf16x2")
    np.testing.assert_allclose(t._sqnorms.numpy(), np.asarray(j._sqnorms),
                               rtol=1e-6)
    np.testing.assert_allclose(t._stage1_center.numpy(),
                               np.asarray(j._stage1_center), atol=1e-6)
    np.testing.assert_allclose(float(t._center_sqmax),
                               float(np.asarray(j._center_sqmax)), rtol=1e-5)
    hi_j = np.asarray(j._stage1_bf16.astype(np.float32))
    assert (t._stage1_bf16.float().numpy() == hi_j).mean() > 0.999
    assert t._stage1_bf16.dtype == t._stage1_lo.dtype == torch.bfloat16
    # fused_args: the f32 tier's tensors, named as flat_topk takes them
    args = t.fused_args()
    assert args.corpus is t._device_corpus
    np.testing.assert_array_equal(args.corpus.numpy(),
                                  np.asarray(j.fused_args()[0]))
    assert args.corpus_sqnorm is t._sqnorms
    assert args.corpus_bf16 is t._stage1_bf16
    assert args.corpus_center is t._stage1_center
    assert args.center_sqmax is t._center_sqmax
    assert args.corpus_bf16_lo is t._stage1_lo
    # the lo residues are exactly what the bf16 hi parts leave over
    centered = t._device_corpus - t._stage1_center[None, :]
    torch.testing.assert_close(
        t._stage1_lo, (centered - t._stage1_bf16.float()).bfloat16(),
        rtol=0, atol=0)
    t._set_stage1_mode("scan")
    assert t.fused_args().corpus_bf16_lo is None
    with pytest.raises(ValueError, match="stage-1 mode"):
        t._set_stage1_mode("int8")


def test_probe_routes_margin_free_corpus_to_scan(rng):
    """Every row present 64 times: the 10th and 33rd best scores are equal
    for every probe, so no stage 1 can prove anything and the probe
    serves the f32 scan, as the JAX probe does."""
    d = 16
    base = rng.standard_normal((tft.TWO_STAGE_MIN_N // 64, d)).astype(
        np.float32)
    corpus = np.repeat(base, 64, axis=0)
    j, t = _pair("ip", corpus)
    assert j._stage1_mode == "scan"
    assert t._stage1_mode == "scan"
    q = base[:3] + 0.01
    got_s, got_i = t.search(q, 5)
    want_s, want_i = j.search(q, 5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("seq", [
    [0.1, 0.2, 0.3],
    [0.1, 0.9, 0.1, 0.1, 0.1],
    [None, 0.0, 0.0, None, 0.0],
    [0.4, 0.6, 0.4, 0.4],
])
def test_demotion_streak_matches_jax(seq):
    """The same verdict stream drives both packages' demotion alike."""
    j = JaxDenseIndex(8)
    t = DenseIndex(8, device="cpu")
    for idx in (j, t):
        idx._stage1_mode = "bf16x2"
    for frac in seq:
        if frac is None:
            ok_j = ok_t = None
        else:
            ok = np.arange(10) < int(round(frac * 10))
            ok_j, ok_t = ok, torch.from_numpy(ok)
        j._note_proof_verdict(ok_j)
        t._note_proof_verdict(ok_t)
        assert (t._fail_streak, t._stage1_mode) == (
            j._fail_streak, j._stage1_mode)
    assert t.DEMOTE_STREAK == j.DEMOTE_STREAK == 3


def test_failing_proofs_demote_to_scan_and_stay_exact(rng):
    """A bf16 stage 1 forced onto near-ties fails every proof: results stay
    equal to the f32 scan, and the third failing dispatch demotes."""
    n, d = tft.TWO_STAGE_MIN_N, 16
    direction = rng.standard_normal(d).astype(np.float32)
    corpus = direction[None, :] + 1e-6 * rng.standard_normal(
        (n, d)).astype(np.float32)
    t = DenseIndex(d, metric="ip", device="cpu")
    t.add(corpus)
    t.commit()
    t._set_stage1_mode("bf16")
    q = torch.from_numpy(direction[None, :].repeat(3, axis=0))
    want = tft.flat_topk_ref(q, t._device_corpus, 10)[1]
    for step in range(3):
        assert t._stage1_mode == "bf16"
        np.testing.assert_array_equal(t.search(q, 10)[1].numpy(), want.numpy())
        assert t._fail_streak == step + 1
    assert t._stage1_mode == "scan"
    t.add(corpus[:5])
    t.commit()  # a new commit re-probes and resets the streak
    fresh = DenseIndex(d, metric="ip", device="cpu")
    fresh.add(np.concatenate([corpus, corpus[:5]]))
    fresh.commit()
    assert (t._stage1_mode, t._fail_streak) == (fresh._stage1_mode, 0)


def test_full_f32_context_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (False, True), (True, False)):
            torch.backends.cuda.matmul.allow_tf32 = flags[0]
            torch.backends.cudnn.allow_tf32 = flags[1]
            with tft.full_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
            with pytest.raises(RuntimeError):
                with tft.full_f32():
                    raise RuntimeError("inside")
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]


def test_unported_tiers_raise():
    # a mesh is ported (tests/test_torch_sharded_search.py): an object
    # that is not a Mesh raises, and a mesh's int8 tier needs a refine copy
    with pytest.raises(TypeError, match="Mesh"):
        DenseIndex(8, mesh=object(), device="cpu")
    mesh = build_mesh(2, 1, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="refine copy"):
        DenseIndex(8, metric="ip", storage_dtype=torch.int8,
                   refine_dtype=None, mesh=mesh)
    assert DenseIndex(8, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="metric"):
        DenseIndex(8, metric="hamming", device="cpu")
    with pytest.raises(ValueError, match="ip/cosine only"):
        DenseIndex(8, metric="l2", storage_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="quality_fallback"):
        DenseIndex(8, quality_fallback="bf16", device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        DenseIndex(8, storage_dtype=torch.float16, device="cpu")
