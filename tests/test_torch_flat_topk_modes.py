"""The last flat top-k kernels of the port against the JAX package's, on the
CPU: modes fasti (#7), fastg (#8) and maxonly (#9) of the running top-k, the
grouped / lane-sliced stage 1 (#3), the (d, N) corpus layout, and
DenseIndex(search_mode="fasti" | "fastg").

Inputs come from a numpy seed and go through both packages; the JAX side
runs its Pallas kernels in interpret mode, the port the kernels' plain
versions (CPU tensors). The packed-key modes are held to #6's function: the
same ids, order and truncated scores, up to one key quantum (2^-11 of a
score) where the two packages' f32 sums round differently. Where the JAX
kernels are wrong (a near-empty last tile for #7 / #8, pads and row scales
for #9) the tests show both the fault and the port's corrected result.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex

from persian_rag_tpu_torch.index.dense import DenseIndex

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")
tft = importlib.import_module("persian_rag_tpu_torch.ops.flat_topk")

# (n, d, k, tile_q, tile_n) as tests/test_kernel_modes.py runs the modes
CASES = [(900, 48, 7, 8, 256), (1003, 32, 10, 16, 256)]
QUANTUM = 2.0 ** -11  # one packed-key quantum, relative to the score


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, n, d, n_q=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n_q, d)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_modes():
    """JAX's fasti / fastg / maxonly over CASES, computed once."""
    out = {}
    for ci, (n, d, k, tq, tn) in enumerate(CASES):
        c, q = _case(ci, n, d)
        for metric in ("dot", "l2"):
            for mode in ("fasti", "fastg"):
                s, i = jft.flat_topk_pallas(
                    jnp.asarray(q), jnp.asarray(c), k, metric=metric,
                    tile_q=tq, tile_n=tn, mode=mode, interpret=True)
                out[ci, metric, mode] = (np.asarray(s), np.asarray(i))
    return out


def _assert_fast_equal(got, want, k):
    """Ids, order and truncated scores equal, up to one key quantum on a
    score; where a quantum moved a rank, the sets equal."""
    got_s, got_i = (x.numpy() for x in got)
    want_s, want_i = want
    np.testing.assert_allclose(got_s, want_s, rtol=QUANTUM, atol=1e-6)
    for r in range(got_i.shape[0]):
        if not np.array_equal(got_i[r], want_i[r]):
            assert set(got_i[r]) == set(want_i[r]), r
        assert len(set(got_i[r].tolist())) == k


@pytest.mark.parametrize("mode", ["fasti", "fastg"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_fast_modes_match_pallas(jax_modes, ci, metric, mode):
    n, d, k, _, _ = CASES[ci]
    c, q = _case(ci, n, d)
    got = tft.flat_topk_running(_t(q), _t(c), k, metric, mode=mode)
    assert got[1].dtype == torch.int64
    _assert_fast_equal(got, jax_modes[ci, metric, mode], k)


@pytest.mark.parametrize("n", [258, 900, 1025, 4097])
@pytest.mark.parametrize("k", [1, 4, 10, 70])
@pytest.mark.parametrize("rows", ["f32 dot", "f32 l2", "int8 scaled"])
def test_three_fast_modes_equal(rows, k, n):
    """fast, fasti and fastg return the same lists: the same keys in the
    same order, bit for bit (their plain versions walk the rows by their
    own mechanisms)."""
    rng = np.random.default_rng(n + k)
    q = _t(rng.standard_normal((5, 24)).astype(np.float32))
    kw = {}
    if rows == "int8 scaled":
        c = _t(rng.integers(-127, 128, (n, 24)).astype(np.int8))
        kw = dict(corpus_scale=_t(rng.uniform(0.5, 2.0, n).astype(
            np.float32)), compute_dtype=torch.bfloat16)
    else:
        base = rng.standard_normal((n // 3 + 1, 24)).astype(np.float32)
        c = _t(base[rng.integers(0, len(base), n)])  # many exact ties
        kw = dict(metric=rows.split()[1])
    want = tft.flat_topk_running(q, c, k, mode="fast", **kw)
    for mode in ("fasti", "fastg"):
        got = tft.flat_topk_running(q, c, k, mode=mode, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    s, i = want[0].numpy(), want[1].numpy()
    tied = s[:, 1:] == s[:, :-1]
    assert (i[:, 1:][tied] > i[:, :-1][tied]).all()


@pytest.mark.parametrize("n", [258, 1025])
def test_near_empty_last_tile_corrected(n):
    """The last 256-row tile holds 1-2 real rows, fewer than n_easy = 4:
    JAX's #7 writes 3e38 scores with duplicated ids and #8 NaN scores (pad
    columns keyed INT_MIN decode to NaN); the port's fasti and fastg keep
    the exact fast-mode set."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    k = 5
    ref = tft.flat_topk_ref(_t(q), _t(c), k)[1].numpy()
    fast = tft.flat_topk_running(_t(q), _t(c), k, mode="fast")
    for mode in ("fasti", "fastg"):
        s, i = tft.flat_topk_running(_t(q), _t(c), k, mode=mode)
        assert torch.equal(s, fast[0]) and torch.equal(i, fast[1])
        assert torch.isfinite(s).all()
        for r in range(3):
            assert set(i[r].tolist()) == set(ref[r].tolist())
    ji = {}
    for mode in ("fasti", "fastg"):
        s, i = jft.flat_topk_pallas(jnp.asarray(q), jnp.asarray(c), k,
                                    tile_q=8, tile_n=256, mode=mode,
                                    interpret=True)
        ji[mode] = (np.asarray(s), np.asarray(i))
    s, i = ji["fasti"]
    assert (s[0] > 1e38).any() and len(set(i[0].tolist())) < k
    assert np.isnan(ji["fastg"][0]).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_maxonly_matches_pallas_where_aligned(metric):
    """N a tile multiple, no row scales: the floor equals JAX's."""
    c, q = _case(5, 1024, 32, n_q=6)
    got_s, got_i = tft.flat_topk_running(_t(q), _t(c), 4, metric,
                                         mode="maxonly")
    want_s, want_i = jft.flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), 4, metric=metric, tile_q=8,
        tile_n=256, mode="maxonly", interpret=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i.numpy() == -1).all()


def test_maxonly_masks_pads_and_folds_scales():
    """JAX's #9 scores pad rows 0 and ignores row scales; the port takes the
    maximum over the real rows of the scaled scores."""
    rng = np.random.default_rng(6)
    c = -np.abs(rng.standard_normal((1003, 16)).astype(np.float32))
    q = np.abs(rng.standard_normal((2, 16)).astype(np.float32))
    true = (q.astype(np.float64) @ c.T.astype(np.float64)).max(axis=1)
    got = tft.flat_topk_running(_t(q), _t(c), 3, mode="maxonly")[0].numpy()
    np.testing.assert_allclose(got[:, 0], true, rtol=1e-5)
    assert (true < 0).all()
    want = np.asarray(jft.flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), 3, tile_q=8, tile_n=256,
        mode="maxonly", interpret=True)[0])
    assert (want == 0).all()  # the pad rows' score

    c8 = rng.integers(-127, 128, (1024, 16)).astype(np.int8)
    scale = np.full(1024, 0.01, np.float32)
    qb = torch.tensor(q).bfloat16().float().numpy().astype(np.float64)
    true = (qb @ (c8.astype(np.float64) * 0.01).T).max(axis=1)
    got = tft.flat_topk_running(
        _t(q), _t(c8), 3, corpus_scale=_t(scale),
        compute_dtype=torch.bfloat16, mode="maxonly")[0].numpy()
    np.testing.assert_allclose(got[:, 0], true, rtol=1e-5)
    want = np.asarray(jft.flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(c8), 3, corpus_scale=jnp.asarray(scale),
        compute_dtype=jnp.bfloat16, tile_q=8, tile_n=256, mode="maxonly",
        interpret=True)[0])
    np.testing.assert_allclose(want[:, 0], true * 100, rtol=1e-5)


@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
@pytest.mark.parametrize("d,qb", [(384, 64), (1210, 32)])
def test_maxonly_geometry_picks_queries_per_block(d, qb, elem_bytes):
    """#9's launch: 64 queries a block where they fit shared memory beside
    the ring (d = 384), else 32 (d = 1,210, the widest rows the segment
    kernels took); segments of whole 256-row tiles that cover N, with
    enough blocks for 132 SMs."""
    for n_q, n in ((64, 100_000), (9, 1003), (2048, 20_481)):
        geo = tft.maxonly_geometry(n_q, n, d, elem_bytes, 132)
        assert geo.qb == qb
        assert geo.smem == tft.maxonly_smem(d, elem_bytes, qb)
        assert geo.smem <= tft._SMEM_LIMIT
        assert geo.rows_per_seg % 256 == 0
        assert geo.n_seg == -(-n // geo.rows_per_seg) <= 65_535
        assert geo.blocks == -(-n_q // qb) * geo.n_seg
        # the longest segments that still give each query block its
        # share of the 132 SMs (one block each: smem > half an SM's)
        per, n_tiles = geo.rows_per_seg // 256, -(-n // 256)
        assert geo.smem > tft._SM_SMEM // 2
        assert per == 1 or -(-n_tiles // (per - 1)) > -(-132 // -(-n_q // qb))
        assert geo.n_seg <= -(-132 // -(-n_q // qb))
    if (d, elem_bytes) == (384, 1):
        # the kernels line: one query block over 131 segments of 768 rows
        assert tft.maxonly_geometry(64, 100_000, d, 1, 132) == (
            64, 768, 131, 131, 166_400)


def test_maxonly_geometry_refuses_rows_past_shared_memory():
    """Rows past what a 32-query block holds beside the ring are not
    refused: the block stages its queries in even windows of 64-byte slabs
    (d = 1,400 f32: 88 slabs, two windows of 44), within shared memory."""
    geo = tft.maxonly_geometry(64, 1000, 1400, 4, 132)
    assert geo.qb == 32
    assert geo.smem == 44 * 16 * 36 * 4 + 2 * 256 * 80 + 2 * 32 * 4
    assert geo.smem <= tft._SMEM_LIMIT
    assert tft.maxonly_smem(1328, 4, 32) == 83 * 16 * 36 * 4 + (
        2 * 256 * 80 + 2 * 32 * 4)  # the widest whole width


# -- #3: grouped and lane-sliced stage 1 -----------------------------------------

N3, D3, Q3, NE = 5000, 64, 24, 4
GROUPED = [(256, dict(group=16)), (1024, dict(lane_slots=8, lane_depth=2)),
           (1024, dict(lane_slots=8, lane_depth=3))]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def stage1():
    rng = np.random.default_rng(33)
    corpus, q = _unit(rng, N3, D3), _unit(rng, Q3, D3)
    out = {}
    for metric in ("dot", "l2"):
        csq = (corpus.astype(np.float64) ** 2).sum(1).astype(np.float32)
        for tn, kw in GROUPED:
            keys, bounds, _ = jft.flat_topk_candidates(
                jnp.asarray(q), jnp.asarray(corpus).astype(jnp.bfloat16),
                metric=metric,
                corpus_sqnorm=jnp.asarray(csq) if metric == "l2" else None,
                tile_n=tn, tile_q=8, n_easy=NE, interpret=True, **kw)
            out[metric, tn, tuple(kw.items())] = (np.asarray(keys),
                                                  np.asarray(bounds))
    return corpus, q, out


def _packed_keys(q, corpus, tile_n, metric):
    """Every row's packed key from the same bf16 arithmetic (numpy f32)."""
    q16 = torch.tensor(q).bfloat16().float()
    c16 = torch.tensor(corpus).bfloat16().float()
    with tft.full_f32():
        s = q16 @ c16.T
    if metric == "l2":
        s = 2.0 * s - torch.tensor((corpus.astype(np.float64) ** 2).sum(1)
                                   .astype(np.float32))[None, :]
    col = torch.arange(s.shape[1]) % tile_n
    return ((tft._score_to_ikey(s) & ~tft._COL_MASK) | (tile_n - 1 - col)
            ).numpy().astype(np.int64)


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("tn,kw", GROUPED, ids=["group16", "lane8x2",
                                                 "lane8x3"])
def test_grouped_candidates_match_jax(stage1, tn, kw, metric):
    corpus, q, jax_out = stage1
    csq = _t((corpus.astype(np.float64) ** 2).sum(1).astype(np.float32))
    keys, bounds, got_tn = tft.flat_topk_candidates(
        _t(q), _t(corpus).bfloat16(), metric=metric,
        corpus_sqnorm=csq if metric == "l2" else None, tile_n=tn, n_easy=NE,
        **kw)
    assert got_tn == tn
    keys, bounds = keys.numpy(), bounds.numpy()
    want_k, want_b = jax_out[metric, tn, tuple(kw.items())]
    assert keys.shape == want_k.shape and bounds.shape == want_b.shape
    # the same arithmetic up to f32 summation order
    assert (keys == want_k).mean() > 0.98
    assert (bounds == want_b).mean() > 0.98
    # the bound covers every key not extracted (validity, not tightness)
    packed = _packed_keys(q, corpus, tn, metric)
    for qi in range(Q3):
        for j in range(-(-N3 // tn)):
            tile = packed[qi, j * tn:(j + 1) * tn]
            taken = set(keys[qi, j * NE:(j + 1) * NE].tolist())
            rest = [p for p in tile.tolist() if p not in taken]
            assert not rest or max(rest) <= int(bounds[qi, j]), (qi, j)


@pytest.mark.parametrize("group", [1, 4, 16, 64])
def test_group_equals_lane_depth_two(group):
    """group = G is the lane-sliced reduction with G slots at depth 2, bit
    for bit; int8 rows with scales take it too."""
    rng = np.random.default_rng(group)
    c = _t(_unit(rng, 3000, 32)).bfloat16()
    q = _t(rng.standard_normal((5, 32)).astype(np.float32))
    a = tft.flat_topk_candidates(q, c, tile_n=512, group=group)
    b = tft.flat_topk_candidates(q, c, tile_n=512, lane_slots=group,
                                 lane_depth=2)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
    c8 = _t(rng.integers(-127, 128, (3000, 32)).astype(np.int8))
    scale = _t(rng.uniform(0.5, 2.0, 3000).astype(np.float32))
    a = tft.flat_topk_candidates(q, c8, corpus_scale=scale, tile_n=512,
                                 group=group)
    b = tft.flat_topk_candidates(q, c8, corpus_scale=scale, tile_n=512,
                                 lane_slots=group, lane_depth=2)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))


def test_grouped_int8_candidates_match_jax():
    rng = np.random.default_rng(34)
    c8 = rng.integers(-127, 128, (3000, 32)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    got = tft.flat_topk_candidates(_t(q), _t(c8), corpus_scale=_t(scale),
                                   tile_n=512, n_easy=5, group=16)
    want = jft.flat_topk_candidates(
        jnp.asarray(q), jnp.asarray(c8), corpus_scale=jnp.asarray(scale),
        tile_n=512, tile_q=8, n_easy=5, interpret=True, group=16)
    for g, w in zip(got[:2], want[:2]):
        assert (g.numpy() == np.asarray(w)).mean() > 0.98


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("kw", [dict(group=16),
                                dict(lane_slots=8, lane_depth=3)],
                         ids=["group16", "lane8x3"])
def test_exact2_stream_grouped_matches_jax(kw, metric):
    rng = np.random.default_rng(35)
    corpus, q = _unit(rng, N3, D3), _unit(rng, 16, D3)
    got_s, got_i = tft.flat_topk_exact2_stream(
        _t(q), _t(corpus), 10, metric, tile_n=1024, **kw)
    want_s, want_i = jft.flat_topk_exact2_stream(
        jnp.asarray(q), jnp.asarray(corpus), 10, metric, tile_n=1024,
        tile_q=16, interpret=True, **kw)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)
    ref = tft.flat_topk_ref(_t(q), _t(corpus), 10, metric)[1]
    assert torch.equal(got_i, ref)


def test_grouped_refusals():
    q = torch.zeros((2, 16))
    c = torch.zeros((1000, 16)).bfloat16()
    with pytest.raises(ValueError, match="multiple"):
        tft.flat_topk_candidates(q, c, tile_n=512, group=24)
    with pytest.raises(ValueError, match="bf16x2"):
        tft.flat_topk_candidates(q, c, tile_n=512, group=16, corpus_lo=c)
    with pytest.raises(ValueError, match="bf16x2"):
        tft.flat_topk_candidates(q, c.T, tile_n=512, corpus_lo=c.T,
                                 corpus_transposed=True)
    with pytest.raises(ValueError, match="lane_depth"):
        tft.flat_topk_candidates(q, c, tile_n=512, lane_slots=8, lane_depth=0)


# -- the (d, N) layout -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16 dot", "bf16 l2", "int8", "group",
                                  "lane"])
def test_transposed_candidates_bit_equal_and_match_jax(kind):
    rng = np.random.default_rng(36)
    corpus, q = _unit(rng, 2100, 32), rng.standard_normal((5, 32)).astype(
        np.float32)
    metric = "l2" if kind == "bf16 l2" else "dot"
    csq = (corpus.astype(np.float64) ** 2).sum(1).astype(np.float32)
    kw_t = dict(metric=metric, tile_n=512, n_easy=NE,
                corpus_sqnorm=_t(csq) if metric == "l2" else None)
    kw_j = dict(metric=metric, tile_n=512, n_easy=NE, tile_q=8,
                interpret=True,
                corpus_sqnorm=jnp.asarray(csq) if metric == "l2" else None)
    rows = corpus.astype(np.float32)
    if kind == "int8":
        rows = rng.integers(-127, 128, (2100, 32)).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, 2100).astype(np.float32)
        kw_t["corpus_scale"], kw_j["corpus_scale"] = _t(scale), jnp.asarray(
            scale)
    extra = {"group": dict(group=16),
             "lane": dict(lane_slots=4, lane_depth=3)}.get(kind, {})
    c_t = _t(rows) if kind == "int8" else _t(rows).bfloat16()
    c_j = jnp.asarray(rows) if kind == "int8" else jnp.asarray(
        rows).astype(jnp.bfloat16)
    base = tft.flat_topk_candidates(_t(q), c_t, **kw_t, **extra)
    trans = tft.flat_topk_candidates(_t(q), c_t.T.contiguous(), **kw_t,
                                     **extra, corpus_transposed=True)
    assert all(torch.equal(a, b) for a, b in zip(base[:2], trans[:2]))
    want = jft.flat_topk_candidates(jnp.asarray(q), c_j.T, **kw_j, **extra,
                                    corpus_transposed=True)
    for g, w in zip(trans[:2], want[:2]):
        assert (g.numpy() == np.asarray(w)).mean() > 0.98


@pytest.mark.parametrize("mode", ["exact", "fast", "fasti", "fastg",
                                  "maxonly"])
@pytest.mark.parametrize("rows", ["f32 l2", "int8 scaled"])
def test_transposed_running_bit_equal_and_match_jax(rows, mode):
    rng = np.random.default_rng(37)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    if rows == "int8 scaled":
        c = rng.integers(-127, 128, (700, 24)).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, 700).astype(np.float32)
        kw_t = dict(corpus_scale=_t(scale), compute_dtype=torch.bfloat16)
        kw_j = dict(corpus_scale=jnp.asarray(scale),
                    compute_dtype=jnp.bfloat16)
    else:
        c = rng.standard_normal((700, 24)).astype(np.float32)
        kw_t = kw_j = dict(metric="l2")
    base = tft.flat_topk_running(_t(q), _t(c), 8, mode=mode, **kw_t)
    trans = tft.flat_topk_running(_t(q), _t(c.T), 8, mode=mode,
                                  corpus_transposed=True, **kw_t)
    assert torch.equal(base[0], trans[0]) and torch.equal(base[1], trans[1])
    if mode == "maxonly":
        return  # JAX's floor scores pads 0 (700 is no tile multiple)
    want = jft.flat_topk_pallas(jnp.asarray(q), jnp.asarray(c.T), 8,
                                tile_q=8, tile_n=256, mode=mode,
                                interpret=True, corpus_transposed=True,
                                **kw_j)
    np.testing.assert_array_equal(trans[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(trans[0].numpy(), np.asarray(want[0]),
                               rtol=QUANTUM, atol=1e-5)


def test_transposed_exact2_stream_equals_row_major():
    rng = np.random.default_rng(38)
    corpus, q = _unit(rng, 4097, 32), rng.standard_normal((6, 32)).astype(
        np.float32)
    for metric in ("dot", "l2"):
        a = tft.flat_topk_exact2_stream(_t(q), _t(corpus), 5, metric,
                                        tile_n=512, group=16)
        image = _t(corpus).bfloat16().T.contiguous()
        b = tft.flat_topk_exact2_stream(_t(q), _t(corpus), 5, metric,
                                        tile_n=512, group=16,
                                        corpus_bf16=image,
                                        bf16_transposed=True)
        c = tft.flat_topk_exact2_stream(_t(q), _t(corpus), 5, metric,
                                        tile_n=512, group=16,
                                        bf16_transposed=True)
        for other in (b, c):
            assert torch.equal(a[0], other[0]) and torch.equal(a[1], other[1])


# -- DenseIndex ----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fasti", "fastg"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dense_index_search_modes_match_jax(metric, mode):
    rng = np.random.default_rng(39)
    corpus = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((7, 32)).astype(np.float32)
    j = JaxDenseIndex(32, metric=metric, search_mode=mode, use_pallas=True)
    t = DenseIndex(32, metric=metric, device="cpu", search_mode=mode)
    fast = DenseIndex(32, metric=metric, device="cpu", search_mode="fast")
    for index in (j, t, fast):
        index.add(corpus)
    want_s, want_i = j.search(queries, 10)
    got_s, got_i = t.search(queries, 10)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=5e-4, atol=5e-4)
    fast_s, fast_i = fast.search(queries, 10)
    assert torch.equal(got_i, fast_i) and torch.equal(got_s, fast_s)


def test_dense_index_rejects_unknown_search_mode():
    """The JAX index takes any string and fails at its first search; the
    port refuses it at construction, and maxonly (no ids) with it."""
    for mode in ("fastest", "maxonly", ""):
        with pytest.raises(ValueError, match="search_mode"):
            DenseIndex(8, device="cpu", search_mode=mode)
    for mode in tft.SEARCH_MODES:
        assert DenseIndex(8, device="cpu", search_mode=mode).search_mode \
            == mode
