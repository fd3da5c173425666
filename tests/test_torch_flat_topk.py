"""The port's flat top-k (persian_rag_tpu_torch.ops.flat_topk) against the
JAX package's, on the CPU.

Inputs come from a numpy seed and go through both packages. Where the JAX
function reaches a Pallas kernel it runs in interpret mode; the port runs
the kernels' plain PyTorch version (CPU tensors). The stage-1 candidates
of the two are held to the same contract rather than bit-equality: the
f32 sums run in different orders, which may move a key by one quantum.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# `persian_rag_tpu.ops.flat_topk` as an attribute is the FUNCTION (the ops
# package re-exports it under the same name): import the modules by path
jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")
tft = importlib.import_module("persian_rag_tpu_torch.ops.flat_topk")


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- key packing and proof constants ------------------------------------------


def test_key_helpers_match_jax():
    vals = np.array(
        [0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-45, -1e-45, 1e-40,
         -1e-40, 1.17549435e-38, -2.5, 123456.78, -7e-3, np.inf, -np.inf],
        np.float32,
    )
    got = tft._score_to_ikey(_t(vals)).numpy()
    want = np.asarray(jft._score_to_ikey(jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)
    back = tft._ikey_to_score(_t(got)).numpy()
    np.testing.assert_array_equal(back.view(np.int32), vals.view(np.int32))
    # monotone: a < b  =>  ikey(a) < ikey(b)
    less = vals[:, None] < vals[None, :]
    assert (got[:, None] < got[None, :])[less].all()
    # truncation as the two-stage bound applies it
    trunc = got & ~tft._COL_MASK
    np.testing.assert_array_equal(
        tft._ikey_to_score(_t(trunc)).numpy(),
        np.asarray(jft._ikey_to_score(jnp.asarray(trunc))),
    )


@pytest.mark.parametrize("d", [1, 16, 64, 384, 768, 1024])
def test_eps_functions_equal_jax(d):
    assert tft._bf16_matmul_eps(d) == jft._bf16_matmul_eps(d)
    assert tft._bf16x2_matmul_eps(d) == jft._bf16x2_matmul_eps(d)


def test_constants_match_jax():
    assert tft.TWO_STAGE_MIN_N == jft.TWO_STAGE_MIN_N
    assert (tft._COL_BITS, tft._COL_MASK, tft._INT_MIN) == (
        jft._COL_BITS, jft._COL_MASK, jft._INT_MIN,
    )


# -- stage-1 candidates ------------------------------------------------------


def _check_contract(cand, bound, tn, n_easy, ref, eps):
    """cand (Q, J*n_easy), bound (Q, J) packed keys against ref (Q, N)
    float64 scores of the rows the image approximates within eps (Q,)."""
    n_q, n = ref.shape
    dec = lambda k: tft._ikey_to_score(_t(k & ~tft._COL_MASK)).numpy()  # noqa
    val = dec(cand).astype(np.float64)
    bump = val + np.abs(val) * 2.0 ** -11
    tile = np.arange(cand.shape[1]) // n_easy
    rows = tile[None, :] * tn + (tn - 1 - (cand & tft._COL_MASK))
    present = cand != tft._INT_MIN
    assert (rows[present] < n).all()
    taken = np.zeros((n_q, n), bool)
    for qi in range(n_q):
        r = rows[qi][present[qi]]
        got = ref[qi, r]
        assert (got <= bump[qi][present[qi]] + eps[qi]).all()
        assert (got >= val[qi][present[qi]] - eps[qi]).all()
        taken[qi, r] = True
    bval = dec(bound).astype(np.float64)
    bval = bval + np.abs(bval) * 2.0 ** -11
    for j in range(bound.shape[1]):
        block = np.where(taken[:, j * tn:(j + 1) * tn], -np.inf,
                         ref[:, j * tn:(j + 1) * tn])
        assert (block.max(axis=1) <= bval[:, j] + eps).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("x2", [False, True], ids=["bf16", "bf16x2"])
def test_plain_candidates_hold_contract_like_jax(rng, metric, x2):
    n, d, nq, tn, n_easy = 1800, 64, 8, 512, 4
    corpus = _unit_rows(rng, n, d)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    hi_t = _t(corpus).bfloat16()
    lo_t = (_t(corpus) - hi_t.float()).bfloat16() if x2 else None
    csq = (corpus.astype(np.float64) ** 2).sum(1).astype(np.float32)
    got_c, got_b, got_tn = tft.flat_topk_candidates(
        _t(queries), hi_t, metric=metric,
        corpus_sqnorm=_t(csq) if metric == "l2" else None,
        tile_n=tn, n_easy=n_easy, corpus_lo=lo_t,
    )
    q_j = jnp.asarray(queries)
    hi_j = jnp.asarray(corpus).astype(jnp.bfloat16)
    kw = {}
    if x2:
        kw = dict(
            corpus_lo=(jnp.asarray(corpus) - hi_j.astype(jnp.float32)).astype(
                jnp.bfloat16),
            queries_lo=q_j - q_j.astype(jnp.bfloat16).astype(jnp.float32),
        )
    want_c, want_b, want_tn = jft.flat_topk_candidates(
        q_j, hi_j, metric=metric,
        corpus_sqnorm=jnp.asarray(csq) if metric == "l2" else None,
        tile_n=tn, tile_q=8, n_easy=n_easy, interpret=True, **kw,
    )
    assert got_tn == want_tn == tn
    want_c, want_b = np.asarray(want_c), np.asarray(want_b)
    assert got_c.shape == want_c.shape and got_b.shape == want_b.shape

    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    err_f = 1.0
    if metric == "l2":
        ref = 2 * ref - csq[None, :]
        err_f = 2.0
    eps_mm = (tft._bf16x2_matmul_eps if x2 else tft._bf16_matmul_eps)(d)
    eps = err_f * eps_mm * np.linalg.norm(queries, axis=1) * np.sqrt(csq.max())
    for cand, bound in ((got_c.numpy(), got_b.numpy()), (want_c, want_b)):
        _check_contract(cand, bound, tn, n_easy, ref, eps)
    # same arithmetic up to f32 summation order: nearly every key agrees
    assert (got_c.numpy() == want_c).mean() > 0.98
    assert (got_b.numpy() == want_b).mean() > 0.98


def test_candidates_refuse_other_devices():
    q = torch.zeros((4, 16), device="meta")
    c = torch.zeros((1000, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device type meta"):
        tft.flat_topk_candidates(q, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tft.extract_candidates_bf16_cuda(q, c, None, 512, 4)
    assert tft.extract_candidates_bf16_cuda.launches == 0
    assert tft.extract_candidates_bf16x2_cuda.launches == 0


# -- the two-stage regime ------------------------------------------------------


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize(
    "variant", ["plain", "centered", "bf16x2"],
)
@pytest.mark.parametrize("n,d,q,k,ks", [(5000, 64, 16, 10, 32),
                                        (4097, 128, 8, 5, 16)])
def test_exact2_stream_matches_jax(rng, metric, variant, n, d, q, k, ks):
    corpus = _unit_rows(rng, n, d)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if variant != "plain":
        mu = corpus.mean(axis=0).astype(np.float32)
        centered = corpus - mu[None, :]
        sqmax = np.float32((centered.astype(np.float32) ** 2).sum(1).max())
        hi_t = _t(centered).bfloat16()
        hi_j = jnp.asarray(centered).astype(jnp.bfloat16)
        kw_t = dict(corpus_center=_t(mu), center_sqmax=torch.tensor(sqmax),
                    corpus_bf16=hi_t)
        kw_j = dict(corpus_center=jnp.asarray(mu),
                    center_sqmax=jnp.asarray(sqmax), corpus_bf16=hi_j)
        if variant == "bf16x2":
            kw_t["corpus_bf16_lo"] = (_t(centered) - hi_t.float()).bfloat16()
            kw_j["corpus_bf16_lo"] = (
                jnp.asarray(centered) - hi_j.astype(jnp.float32)
            ).astype(jnp.bfloat16)
    got_s, got_i, got_ok = tft.flat_topk_exact2_stream(
        _t(queries), _t(corpus), k, metric, k_scan=ks, tile_n=512,
        return_ok=True, **kw_t,
    )
    want_s, want_i, want_ok = jft.flat_topk_exact2_stream(
        jnp.asarray(queries), jnp.asarray(corpus), k, metric, k_scan=ks,
        tile_n=512, tile_q=8, interpret=True, return_ok=True, **kw_j,
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-4
    )
    want_ok = np.asarray(want_ok)
    assert np.array_equal(got_ok.numpy(), want_ok), (
        "a query sits at the proof boundary: the two packages' stage-1 "
        f"sums decided it differently ({got_ok.numpy()} vs {want_ok})"
    )
    assert want_ok.mean() >= 0.75


def test_exact2_stream_sliced_fallback_rescans_failing_slices(
    rng, monkeypatch
):
    """More than PROOF_SLICE queries, the last ones unprovable (they hit a
    planted near-tie cluster): only their slice is rescanned, and the
    result equals the f32 scan."""
    d, n, k = 128, 3000, 3
    corpus = _unit_rows(rng, n, d)
    direction = corpus[0]
    corpus[:40] = direction[None, :] + 1e-7 * rng.standard_normal(
        (40, d)).astype(np.float32)
    queries = _unit_rows(rng, 300, d)
    queries[260:] = direction
    rescanned = []
    ref = tft.flat_topk_ref
    monkeypatch.setattr(
        tft, "flat_topk_ref",
        lambda q, *a, **kw: rescanned.append(q.shape[0]) or ref(q, *a, **kw),
    )
    got_s, got_i, ok = tft.flat_topk_exact2_stream(
        _t(queries), _t(corpus), k, "dot", k_scan=32, tile_n=512,
        return_ok=True,
    )
    ok = ok.numpy()
    assert ok[:256].all() and not ok[260:].any()
    assert rescanned == [300 - tft.PROOF_SLICE]
    want_s, want_i = ref(_t(queries), _t(corpus), k, "dot")
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_s[256:].numpy(), want_s[256:].numpy())
    np.testing.assert_allclose(
        got_s.numpy(), want_s.numpy(), rtol=1e-6, atol=1e-6
    )


def test_duplicate_rows_tie_break_lower_id(rng):
    d, k = 32, 8
    base = rng.standard_normal((2000, d)).astype(np.float32)
    base[777] = base[33]
    base[1500] = base[33]
    base[1999] = base[12]
    queries = base[[33, 12]] + 0.0
    want_s, want_i = jft.flat_topk_ref(
        jnp.asarray(queries), jnp.asarray(base), k, "dot"
    )
    want_i = np.asarray(want_i)
    assert list(want_i[0][:3]) == [33, 777, 1500]
    for got_s, got_i in (
        tft.flat_topk_exact2_stream(
            _t(queries), _t(base), k, "dot", k_scan=32, tile_n=512),
        tft.flat_topk_ref(_t(queries), _t(base), k, "dot"),
        tft.flat_topk_scan(_t(queries), _t(base), k, "dot", chunk=700),
    ):
        np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_mass_ties_prefer_lower_ids():
    """Every row equal: every path must return ids 0..k-1 in order."""
    corpus = np.ones((3000, 16), np.float32)
    queries = np.ones((3, 16), np.float32)
    for metric in ("dot", "l2"):
        for _, got_i in (
            tft.flat_topk_ref(_t(queries), _t(corpus), 7, metric),
            tft.flat_topk_scan(_t(queries), _t(corpus), 7, metric, chunk=512),
            tft.flat_topk_exact2_stream(
                _t(queries), _t(corpus), 7, metric, tile_n=512),
        ):
            assert (got_i.numpy() == np.arange(7)[None, :]).all()


def test_near_tie_fallback(rng):
    d, n, k = 64, 4200, 10
    direction = rng.standard_normal(d).astype(np.float32)
    direction /= np.linalg.norm(direction)
    corpus = direction[None, :] + 1e-6 * rng.standard_normal((n, d)).astype(
        np.float32)
    queries = direction[None, :].repeat(3, axis=0).astype(np.float32)
    got_s, got_i, ok = tft.flat_topk_exact2_stream(
        _t(queries), _t(corpus), k, "dot", k_scan=16, tile_n=512,
        return_ok=True,
    )
    assert not ok.numpy().any()  # the proof cannot hold: fallback ran
    # on ties this tight the summation order decides ranks, so ids are
    # held against the port's own f32 scan and scores against JAX's
    ref_s, ref_i = tft.flat_topk_ref(_t(queries), _t(corpus), k, "dot")
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    want_s, _ = jft.flat_topk_ref(
        jnp.asarray(queries), jnp.asarray(corpus), k, "dot"
    )
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_ref_and_scan_match_jax(rng, metric):
    corpus = rng.standard_normal((1301, 96)).astype(np.float32)
    queries = rng.standard_normal((33, 96)).astype(np.float32)
    want_s, want_i = jft.flat_topk_ref(
        jnp.asarray(queries), jnp.asarray(corpus), 10, metric
    )
    for got_s, got_i in (
        tft.flat_topk_ref(_t(queries), _t(corpus), 10, metric),
        tft.flat_topk_scan(_t(queries), _t(corpus), 10, metric, chunk=500),
    ):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(
            got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-4
        )


# -- dispatcher ------------------------------------------------------------------


def test_dispatcher_regimes(monkeypatch):
    calls = []
    monkeypatch.setattr(
        tft, "flat_topk_exact2_stream",
        lambda *a, **kw: calls.append(kw) or ("TS", "TS"),
    )
    monkeypatch.setattr(tft, "flat_topk_ref", lambda *a, **kw: ("REF", "REF"))
    monkeypatch.setattr(tft, "flat_topk_scan", lambda *a, **kw: ("SC", "SC"))
    monkeypatch.setattr(
        tft, "flat_topk_running", lambda *a, **kw: ("RUN", kw["mode"]))
    q = torch.zeros((4, 16))
    big = torch.zeros((tft.TWO_STAGE_MIN_N, 16))
    assert tft.flat_topk(q, big, 10, metric="dot")[0] == "TS"
    assert tft.flat_topk(q, big, 10, metric="l2", mode="fast")[0] == "TS"
    # a bf16-stored corpus is served by the two-stage regime too
    assert tft.flat_topk(q, big.bfloat16(), 10)[0] == "TS"
    assert len(calls) == 3 and all(
        kw["n_easy"] == 4 and kw["k_scan"] == 32 for kw in calls
    )
    below = torch.zeros((tft.TWO_STAGE_MIN_N - 1, 16))
    assert tft.flat_topk(q, below, 10)[0] == "REF"
    assert tft.flat_topk(q, big, 129)[0] == "REF"  # k above the kernels'
    assert tft.flat_topk(q, big, 10, mode="scan")[0] == "SC"
    assert tft.flat_topk(q, big, 10, mode="scan", return_ok=True)[2] is None
    # the running top-k serves what the TPU served with its running kernels
    scale = torch.ones(big.shape[0])
    many = torch.zeros((4096, 16))
    for kw, mode in (
        (dict(queries=many, corpus=big, k=33), "exact"),  # k above the gate
        (dict(queries=q, corpus=below, k=10, mode="fast"), "fast"),
        (dict(queries=q, corpus=big.to(torch.int8), k=10,
              corpus_scale=scale, compute_dtype=torch.bfloat16), "exact"),
        (dict(queries=q, corpus=below, k=10,
              compute_dtype="bfloat16"), "exact"),
        (dict(queries=many, corpus=below, k=10), "exact"),  # past the budget
        (dict(queries=q, corpus=below, k=10, mode="exactns"), "exactns"),
    ):
        assert tft.flat_topk(**kw) == ("RUN", mode)
    assert tft.flat_topk(q, below, 10, mode="fast", return_ok=True)[2] is None


def test_unported_regime_raises_on_device():
    """Every running mode launches its kernels on CUDA tensors and takes
    the plain version on CPU tensors; any other device raises, in either
    corpus layout, as do k past the kernels' limit, row scales with l2 and
    an unknown mode."""
    q = torch.zeros((4096, 16), device="meta")
    c = torch.zeros((30_000, 16), device="meta")
    with pytest.raises(ValueError, match="device type meta"):
        tft.flat_topk(q, c, 10)
    for mode in ("fast", "fasti", "fastg", "maxonly"):
        with pytest.raises(ValueError, match="device type meta"):
            tft.flat_topk(q, c, 10, mode=mode)
        with pytest.raises(ValueError, match="device type meta"):
            tft.flat_topk_running(q, c.T, 10, mode=mode,
                                  corpus_transposed=True)
    with pytest.raises(ValueError, match="device type meta"):
        tft.flat_topk_candidates(q, c.bfloat16(), group=16)
    q, c = torch.zeros((2, 16)), torch.zeros((300, 16))
    with pytest.raises(ValueError, match="k must be"):
        tft.flat_topk_running(q, c, 129)
    with pytest.raises(ValueError, match="k must be"):
        tft.flat_topk_running(q, c.T, 129, mode="fasti",
                              corpus_transposed=True)
    with pytest.raises(ValueError, match="dot/cosine only"):
        tft.flat_topk_running(q, c, 10, metric="l2",
                              corpus_scale=torch.ones(300))
    with pytest.raises(ValueError, match="unknown mode"):
        tft.flat_topk_running(q, c, 10, mode="fastest")
    for mode in ("fasti", "fastg", "maxonly"):
        scores, ids = tft.flat_topk_running(q, c, 10, mode=mode)
        assert scores.shape == ids.shape == (2, 10)
