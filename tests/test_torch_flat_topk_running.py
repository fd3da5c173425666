"""Running top-k and int8 candidate generation of the port against the JAX
package's Pallas kernels (interpret mode), on the CPU.

On CPU tensors the port's wrappers take the kernels' plain PyTorch
versions; the CUDA kernels themselves are held to these plain versions on
the card by chip_smoke.py. Inputs are made from a numpy seed and handed to
both packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

# the JAX package's ops/__init__ rebinds the name `flat_topk` to a function
jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

N, D, Q = 1300, 24, 5  # N is not a multiple of the JAX tile (256)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_running(q, c, k, metric, mode, compute, scale=None):
    return jft.flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), k, metric=metric,
        corpus_scale=None if scale is None else jnp.asarray(scale),
        tile_q=8, tile_n=256, mode=mode, interpret=True,
        compute_dtype=jnp.bfloat16 if compute == "bfloat16" else jnp.float32,
    )


def _assert_same(got, want, mode):
    """exact: ids equal, scores rtol 1e-5 (two f32 accumulation orders);
    fast: ids equal, scores within the packed keys' 21-bit truncation."""
    got_s, got_i = got
    want_s, want_i = want
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if mode.startswith("exact"):
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **tol)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_running_plain_matches_pallas(metric, mode, compute, k):
    rng = np.random.default_rng(11)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    got = tft.flat_topk_running(
        _t(q), _t(c), k, metric=metric, mode=mode, compute_dtype=compute)
    assert got[0].shape == (Q, k) and got[1].dtype == torch.int64
    _assert_same(got, _jax_running(q, c, k, metric, mode, compute), mode)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_running_row_scaled_int8_matches_pallas(mode, k):
    rng = np.random.default_rng(12)
    c = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    got = tft.flat_topk_running(
        _t(q), _t(c), k, corpus_scale=_t(scale), mode=mode,
        compute_dtype=torch.bfloat16)
    _assert_same(
        got, _jax_running(q, c, k, "dot", mode, "bfloat16", scale), mode)
    if mode == "exact":
        # the dispatcher reaches the same regime for row-scaled rows
        via = tft.flat_topk(_t(q), _t(c), k, corpus_scale=_t(scale),
                            compute_dtype=torch.bfloat16)
        np.testing.assert_array_equal(via[1].numpy(), got[1].numpy())


@pytest.mark.parametrize("mode", ["exact", "exactns", "fast", "fastns"])
@pytest.mark.parametrize("corpus_kind", ["duplicates", "all_equal"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_running_tie_order_matches_pallas(metric, corpus_kind, mode):
    """Equal scores keep the lower id, within a tile and across tiles."""
    rng = np.random.default_rng(13)
    if corpus_kind == "duplicates":
        base = rng.standard_normal((40, D)).astype(np.float32)
        c = base[rng.integers(0, 40, size=N)]  # ~32 copies of each row
    else:
        c = np.tile(rng.standard_normal((1, D)).astype(np.float32), (N, 1))
    q = rng.standard_normal((Q, D)).astype(np.float32)
    k = 70  # more than one duplicate group, more than one JAX tile deep
    got = tft.flat_topk_running(_t(q), _t(c), k, metric=metric, mode=mode)
    _assert_same(got, _jax_running(q, c, k, metric, mode, "float32"), mode)
    if corpus_kind == "all_equal":
        assert got[1].tolist() == [list(range(k))] * Q
    s, i = got[0].numpy(), got[1].numpy()
    tied = s[:, 1:] == s[:, :-1]
    assert tied.any() and (i[:, 1:][tied] > i[:, :-1][tied]).all()


def test_running_plain_equals_sort_of_its_own_scores():
    """Exact mode is a stable descending sort of the scores; fast mode of
    the packed keys, returning the truncated scores."""
    rng = np.random.default_rng(14)
    c = _t(rng.standard_normal((3000, D)).astype(np.float32))
    q = _t(rng.standard_normal((Q, D)).astype(np.float32))
    with tft.full_f32():
        s = q @ c.T
    want_s, want_i = torch.sort(s, dim=1, descending=True, stable=True)
    got_s, got_i = tft.flat_topk_running_plain(q, c, 50, chunk=512)
    assert torch.equal(got_i, want_i[:, :50])
    assert torch.equal(got_s, want_s[:, :50])
    keys = tft._score_to_ikey(s) & ~tft._COL_MASK
    want_k, want_i = torch.sort(keys, dim=1, descending=True, stable=True)
    got_s, got_i = tft.flat_topk_running_plain(q, c, 50, mode="fast",
                                               chunk=512)
    assert torch.equal(got_i, want_i[:, :50])
    assert torch.equal(got_s, tft._ikey_to_score(want_k[:, :50]))


@pytest.mark.parametrize("k_scan", [16, 64])
def test_scaled_candidates_match_jax(k_scan):
    """Same candidate id sets as the JAX kernel, and the true top-10 of the
    dequantized scores among them."""
    rng = np.random.default_rng(15)
    n, d, n_q = 6000, 48, 8
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    scales = np.maximum(np.abs(corpus).max(axis=1) / 127.0, 1e-12).astype(
        np.float32)
    values = np.clip(np.rint(corpus / scales[:, None]), -127, 127).astype(
        np.int8)
    queries = rng.standard_normal((n_q, d)).astype(np.float32)
    want = np.asarray(jft.flat_topk_scaled_candidates(
        jnp.asarray(queries), jnp.asarray(values), jnp.asarray(scales),
        k_scan=k_scan, tile_n=512, tile_q=8, interpret=True))
    got = tft.flat_topk_scaled_candidates(
        _t(queries), _t(values), _t(scales), k_scan, tile_n=512).numpy()
    assert got.shape == want.shape == (n_q, k_scan)
    deq = values.astype(np.float32) * scales[:, None]
    top10 = np.argsort(-(queries @ deq.T), axis=1)[:, :10]
    for r in range(n_q):
        assert set(got[r].tolist()) == set(want[r].tolist())
        if k_scan == 64:
            assert set(top10[r]) <= set(got[r].tolist())


def test_scaled_candidates_pad_with_minus_one():
    """Fewer keys than k_scan: the rest of the row is -1."""
    rng = np.random.default_rng(16)
    values = _t(rng.integers(-127, 128, size=(5, 8)).astype(np.int8))
    scales = _t(rng.uniform(0.5, 2.0, size=5).astype(np.float32))
    q = _t(rng.standard_normal((2, 8)).astype(np.float32))
    got = tft.flat_topk_scaled_candidates(q, values, scales, 7)
    assert got.shape == (2, 7)
    assert sorted(got[0, :5].tolist()) == list(range(5))
    assert got[:, 5:].tolist() == [[-1, -1]] * 2


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_ref_with_scale_and_compute_dtype_matches_jax(metric, compute):
    rng = np.random.default_rng(17)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    if metric == "dot":
        c = rng.integers(-127, 128, size=(500, D)).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    else:
        c = rng.standard_normal((500, D)).astype(np.float32)
        scale = None
    want_s, want_i = jft.flat_topk_ref(
        jnp.asarray(q), jnp.asarray(c), 9, metric,
        compute_dtype=jnp.dtype(compute),
        corpus_scale=None if scale is None else jnp.asarray(scale))
    got_s, got_i = tft.flat_topk_ref(
        _t(q), _t(c), 9, metric, compute_dtype=compute,
        corpus_scale=None if scale is None else _t(scale))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


# -- #5 / #6: the stream's geometry and the chain mirror ---------------------------

SMS = 132  # the H100's SMs


@pytest.mark.parametrize("n_q,k,qb", [(1, 10, 8), (8, 128, 8), (9, 10, 16),
                                      (16, 100, 16), (17, 10, 32),
                                      (64, 10, 64), (64, 100, 32),
                                      (64, 128, 32), (512, 10, 64)])
def test_running_geometry_picks_the_query_block(n_q, k, qb):
    """The query block follows Q as the other register streams' does; 64
    queries only where their whole width fits beside k's lists and queues
    (at d = 384 int8 rows: k = 10, not k = 100 or 128). Segments are whole
    256-row chunks and fill the card's resident blocks."""
    geo = tft.running_geometry(n_q, 100_000, 384, k, 1, SMS)
    assert geo.qb == qb
    assert geo.qcap == -(-k // 32) * 32
    assert geo.smem <= tft._SMEM_LIMIT and geo.slabs == 6  # whole width
    assert geo.rows_per_seg % 256 == 0
    assert geo.n_seg == -(-100_000 // geo.rows_per_seg)
    assert geo.blocks == -(-n_q // qb) * geo.n_seg

    def chunks_in_line(per):  # waves of blocks times chunks a block
        blocks = -(-n_q // qb) * -(-391 // per)
        return -(-blocks // (SMS * geo.per_sm)) * per

    assert chunks_in_line(geo.rows_per_seg // 256) == min(
        chunks_in_line(per) for per in range(1, 392))


@pytest.mark.parametrize("d,elem_bytes", [(1024, 1), (2048, 1), (4000, 4),
                                          (2048, 2)])
def test_running_geometry_takes_any_width(d, elem_bytes):
    """Past what a block holds the queries are staged in windows of whole
    slabs, spread evenly: every width fits a block."""
    geo = tft.running_geometry(64, 100_000, d, 128, elem_bytes, SMS)
    slabs = -(-d // (64 // elem_bytes))
    assert geo.qb == 32 and geo.smem <= tft._SMEM_LIMIT
    windows = -(-slabs // geo.slabs)
    assert windows > 1 and -(-slabs // windows) == geo.slabs


def _dup_rows(rng, n, d, edge, kind):
    """Rows (int8 with scales, or bf16) whose 8 rows before `edge` repeat
    just after it, and queries near them, so their ties cross the edge."""
    c = rng.standard_normal((n, d)).astype(np.float32)
    c[edge: edge + 8] = c[edge - 8: edge]
    if kind == "int8":
        c8 = np.clip(np.rint(c * 40), -127, 127).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        scale[edge: edge + 8] = scale[edge - 8: edge]
        return _t(c8), _t(scale), c8.astype(np.float32) * scale[:, None]
    return _t(c).bfloat16(), None, c


@pytest.mark.parametrize("kind,metric", [("int8", "dot"), ("bf16", "l2")])
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("k", [10, 100, 128])
@pytest.mark.parametrize("n_q", [1, 9, 64])
def test_chain_mirror_equals_plain(n_q, k, mode, kind, metric):
    """The lists of #5 / #6 under bf16 compute, mirrored from their chain
    and cut at the kernel's own segments (`running_geometry`), equal the
    plain version's: ids equal and scores as `_assert_same` allows (two f32
    summation orders: rtol 1e-5; fast mode the 21-bit keys), the duplicate
    rows across a segment edge tied with the lower id first."""
    rng = np.random.default_rng(100 + n_q + k)
    n, d = 3000, 40
    elem = 1 if kind == "int8" else 2
    geo = tft.running_geometry(n_q, n, d, k, elem, SMS)
    edge = geo.rows_per_seg
    assert geo.n_seg > 1 and edge < n
    rows, scale, deq = _dup_rows(rng, n, d, edge, kind)
    near = deq[edge - 8 + rng.integers(0, 8, size=n_q)]
    q = _t((near + 0.05 * rng.standard_normal(near.shape)).astype(np.float32))
    kw = dict(metric=metric, corpus_scale=scale, mode=mode)
    got = tft.running_chain_topk(q, rows, k, rows_per_seg=edge, **kw)
    assert torch.equal(got[1], tft.running_chain_topk(q, rows, k, **kw)[1])
    want = tft.flat_topk_running_plain(q, rows, k, compute_dtype=torch.bfloat16,
                                       **kw)
    _assert_same(got, want, mode)
    s, i = got[0].numpy(), got[1].numpy()
    tied = s[:, 1:] == s[:, :-1]
    crossing = tied & (i[:, :-1] < edge) & (i[:, 1:] >= edge)
    assert crossing.any() and (i[:, 1:][tied] > i[:, :-1][tied]).all()


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_chain_mirror_takes_the_transposed_layout(kind):
    """The (d, N) layout gives the (N, d) lists bit for bit, and the
    dispatcher on CPU tensors the plain version's ids."""
    rng = np.random.default_rng(18)
    rows, scale, _ = _dup_rows(rng, 1200, 24, 600, kind)
    q = _t(rng.standard_normal((5, 24)).astype(np.float32))
    a = tft.running_chain_topk(q, rows, 20, corpus_scale=scale)
    b = tft.running_chain_topk(q, rows.t().contiguous(), 20,
                               corpus_scale=scale, transposed=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    via = tft.flat_topk_running(q, rows, 20, corpus_scale=scale,
                                compute_dtype=torch.bfloat16)
    assert torch.equal(via[1], a[1])
