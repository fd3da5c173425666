"""Dense search at widths past what a block's shared memory holds, on the
CPU.

On the card each stage-1 and running top-k kernel holds its queries and a
slab of rows in a block's shared memory. Past what fits (bf16x2 d > 928 at
Q > 8, the running kernels d > 1,038, bf16 and int8 stage 1 d > 2,368, at
fewer queries a block more) a block stages its queries a window of K values
at a time, each chain still running k ascending from +0, so every kernel
takes any d with the same bits, and `flat_topk` picks its regime by the
call's options alone, as the JAX dispatcher does. The JAX package serves any
width. Here, at d = 1,024 and 2,048 (and 4,000):

* no regime depends on the width: each case takes the regime it takes at
  d = 64;
* every regime (f32 two-stage, a bf16x2 index at Q = 8 and 16, the bf16
  stage 1 of a bf16-stored corpus, raw int8 rows, bf16 compute, modes
  fast / fasti / fastg, 32 < k <= 128 past the materialization budget)
  runs its own kernel's regime, and its ids equal the JAX package's
  (`flat_topk_ref` on the CPU, in the call's compute dtype), near-ties
  aside: where ids differ, the two rows' f64 scores over the call's
  operands are within 1e-5 relative (2^-11 for modes fast / fasti /
  fastg, which rank by 21-bit keys: 12 mantissa bits);
* `DenseIndex.search` (f32 with its probe, a bf16x2 pin, bf16 storage, raw
  int8 against the JAX index's Pallas kernels in interpret mode) equals
  the JAX index's ids the same way;
* the commit probe picks its stage 1 by the score margin alone: bf16x2 at
  d = 512 and 1,024 on a corpus whose margin picks it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.index.dense import DenseIndex as JaxDenseIndex

from persian_rag_tpu_torch.index import dense as tdense
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

WIDTHS = (1024, 2048)
N, K = 1500, 10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _truth(q, c, metric, scale=None, bf16=False):
    """(Q, N) f64 scores in maximize space over the call's operands."""
    q64 = (_t(q).bfloat16().float().numpy() if bf16 else q).astype(
        np.float64)
    cf = c.astype(np.float32)
    c64 = (_t(cf).bfloat16().float().numpy() if bf16 else cf).astype(
        np.float64)
    s = q64 @ c64.T
    if scale is not None:
        s = s * scale[None, :].astype(np.float64)
    if metric == "l2":
        s = 2 * s - (cf.astype(np.float64) ** 2).sum(1)[None, :]
    return s


def _assert_ids(got, want, truth, rel=1e-5):
    """ids equal, near-ties aside: where they differ, the two rows' true
    scores are within rel of each other."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = got != want
    g = np.take_along_axis(truth, got.astype(np.int64), 1)
    w = np.take_along_axis(truth, want.astype(np.int64), 1)
    assert (np.abs(g - w)[diff] <= rel * np.abs(w)[diff] + 1e-9).all()
    assert diff.mean() <= 0.05


@pytest.fixture
def routes(monkeypatch):
    """Record each regime flat_topk takes: ("two_stage", stage-1 kernel)
    or ("running", mode)."""
    taken = []
    exact2, running = tft.flat_topk_exact2_stream, tft.flat_topk_running

    def rec_exact2(queries, corpus, k, **kw):
        lo = kw.get("corpus_bf16_lo")
        taken.append(("two_stage", "bf16x2" if lo is not None else "bf16",
                      queries.shape[0]))
        return exact2(queries, corpus, k, **kw)

    def rec_running(queries, corpus, k, **kw):
        taken.append(("running", kw.get("mode", "exact"), queries.shape[0]))
        return running(queries, corpus, k, **kw)

    monkeypatch.setattr(tft, "flat_topk_exact2_stream", rec_exact2)
    monkeypatch.setattr(tft, "flat_topk_running", rec_running)
    # the two-stage regime at test sizes: enough 128-row tiles for k_scan
    monkeypatch.setattr(tft, "TWO_STAGE_MIN_N", 512)
    monkeypatch.setattr(tft, "TWO_STAGE_TILE_N", 128)
    return taken


def _data(d, n=N, n_q=16, seed=0):
    rng = np.random.default_rng(seed + d)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = c[rng.integers(0, n, n_q)] + 0.2 * rng.standard_normal(
        (n_q, d)).astype(np.float32) / np.sqrt(d)
    return c, q.astype(np.float32)


# case -> the regime it takes at every width
CASES = {
    "f32_two_stage": "two_stage:bf16",
    "bf16x2_q16": "two_stage:bf16x2",
    "bf16x2_q8": "two_stage:bf16x2",
    "bf16_storage": "two_stage:bf16",
    "raw_int8": "running:exact",
    "bf16_compute": "running:exact",
    "fast": "running:fast",
    "fasti": "running:fasti",
    "fastg": "running:fastg",
    "k64_past_budget": "running:exact",
}


def _call(case, d, monkeypatch):
    """flat_topk's arguments for `case` at width d: (q, c as the JAX ref
    takes it, corpus, k, metric, row scales, bf16 operands, options)."""
    c, q = _data(d, n_q=8 if case == "bf16x2_q8" else 16)
    metric, k, scale, bf16 = "l2", K, None, False
    corpus, kw = _t(c), {}
    if case in ("f32_two_stage", "bf16x2_q16", "bf16x2_q8"):
        mu = _t(c.mean(0))
        centered = corpus - mu[None, :]
        kw = dict(corpus_bf16=centered.bfloat16(), corpus_center=mu,
                  center_sqmax=(centered * centered).sum(1).max(),
                  corpus_sqnorm=(corpus * corpus).sum(1))
        if case != "f32_two_stage":
            kw["corpus_bf16_lo"] = (centered
                                    - kw["corpus_bf16"].float()).bfloat16()
    elif case == "bf16_storage":
        corpus = corpus.bfloat16()
        c = corpus.float().numpy()
    elif case == "raw_int8":
        metric, bf16 = "dot", True
        scale = np.maximum(np.abs(c).max(1) / 127.0, 1e-12).astype(np.float32)
        c = np.clip(np.rint(c / scale[:, None]), -127, 127).astype(np.int8)
        corpus = _t(c)
        kw = dict(corpus_scale=_t(scale), compute_dtype=torch.bfloat16)
    elif case == "bf16_compute":
        bf16 = True
        kw = dict(compute_dtype=torch.bfloat16)
    elif case in ("fast", "fasti", "fastg"):
        kw = dict(mode=case)
        monkeypatch.setattr(tft, "TWO_STAGE_MIN_N", N + 1)
    else:  # 32 < k <= 128, the score block past the budget
        k = 64
        monkeypatch.setattr(tft, "MATERIALIZE_BUDGET", 1)
    return q, c, corpus, k, metric, scale, bf16, kw


@pytest.mark.parametrize("case", list(CASES))
def test_regime_does_not_depend_on_the_width(routes, monkeypatch, case):
    """The regime a case takes at d = 64 is the one it takes at 1,024,
    2,048 and 4,000: no kernel has a width limit to route around."""
    taken = []
    for d in (64, *WIDTHS, 4000):
        q, _, corpus, k, metric, _, _, kw = _call(case, d, monkeypatch)
        tft.flat_topk(_t(q[:4]) if d == 4000 else _t(q), corpus, k,
                      metric=metric, **kw)
        regime, kernel, _ = routes[-1]
        taken.append(f"{regime}:{kernel}")
    assert taken == [CASES[case]] * 4


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_every_regime_takes_a_route_that_takes_the_width(routes, monkeypatch,
                                                        case, d):
    q, c, corpus, k, metric, scale, bf16, kw = _call(case, d, monkeypatch)
    got_s, got_i = tft.flat_topk(_t(q), corpus, k, metric=metric, **kw)
    want_s, want_i = jft.flat_topk_ref(
        jnp.asarray(q), jnp.asarray(c), k, metric=metric,
        compute_dtype=jnp.bfloat16 if bf16 else None,
        corpus_scale=None if scale is None else jnp.asarray(scale))
    assert len(routes) == 1
    regime, kernel, _ = routes[0]
    assert f"{regime}:{kernel}" == CASES[case]
    # modes fast / fasti / fastg rank by keys of 12 mantissa bits: ties
    # within 2^-11 relative are theirs to break
    _assert_ids(got_i.numpy(), want_i,
                _truth(q, c, metric, scale=scale, bf16=bf16),
                rel=2.0 ** -11 if case in ("fast", "fasti", "fastg") else 1e-5)
    if case in ("f32_two_stage", "bf16_storage", "k64_past_budget"):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)


def test_maxonly_past_its_width_is_the_exact_best(routes):
    """d = 1,400 is past what #9's 32-query block holds in f32: the running
    regime still serves it (the kernel stages its queries in windows), each
    query's best score in every column and no ids."""
    c, q = _data(1400, n=600, n_q=5)
    assert tft.maxonly_geometry(5, 600, 1400, 4, 132).qb == 32
    s, i = tft.flat_topk(_t(q), _t(c), 3, metric="dot", mode="maxonly")
    assert routes == [("running", "maxonly", 5)]
    best = (q.astype(np.float64) @ c.T.astype(np.float64)).max(1)
    np.testing.assert_allclose(s.numpy(), np.repeat(best[:, None], 3, 1),
                               rtol=1e-5)
    assert (i.numpy() == -1).all()


def test_past_every_old_limit_two_stage_runs_the_bf16_stage_one(routes):
    """d = 4,000 is past what #1's block held at any batch (3,968 at Q <=
    8): the two-stage regime, its bf16 stage 1 and proof, equal to the JAX
    ref."""
    c, q = _data(4000, n=800, n_q=4)
    got_s, got_i = tft.flat_topk(_t(q), _t(c), K, metric="dot")
    assert routes == [("two_stage", "bf16", 4)]
    want_s, want_i = jft.flat_topk_ref(jnp.asarray(q), jnp.asarray(c), K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _pair(c, metric, storage, **kw):
    # the int8 tier runs its Pallas kernels in interpret mode, so both
    # packages score it with bf16-rounded queries
    j = JaxDenseIndex(c.shape[1], metric=metric,
                      storage_dtype=jnp.dtype(storage),
                      use_pallas=storage == "int8", **kw)
    t = DenseIndex(c.shape[1], metric=metric, device="cpu",
                   storage_dtype=storage, **kw)
    for index in (j, t):
        index.add(c)
        index.commit()
    return j, t


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("tier", ["f32", "bf16x2_pin", "bf16", "int8"])
def test_dense_index_serves_the_width_like_jax(routes, monkeypatch, tier, d):
    monkeypatch.setattr(tdense, "TWO_STAGE_MIN_N", 512)
    c, q = _data(d, seed=1)
    metric = "ip" if tier == "int8" else "l2"
    storage = {"f32": "float32", "bf16x2_pin": "float32", "bf16": "bfloat16",
               "int8": "int8"}[tier]
    kw = dict(refine_dtype=None) if tier == "int8" else {}
    kw.update(quality_floor=None)
    j, t = _pair(c, metric, storage, **kw)
    if tier == "bf16x2_pin":
        t._set_stage1_mode("bf16x2")
    else:
        assert t._stage1_mode in ("bf16", "bf16x2", "scan")
    _, got_i = t.search(q, K)
    _, want_i = j.search(q, K)
    if tier == "bf16x2_pin":
        # a batch of 16 at either width runs the bf16x2 stage 1
        assert routes[-1] == ("two_stage", "bf16x2", 16)
    if tier in ("f32", "bf16x2_pin"):
        truth = _truth(q, c, "l2")
    elif tier == "bf16":
        truth = _truth(q, t.vectors(), "l2")
    else:  # the centered int8 rows against bf16-rounded queries
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        truth = _truth(qn, t.vectors() - t._center.numpy()[None, :], "dot",
                       bf16=True)
    _assert_ids(got_i.numpy(), np.asarray(want_i), truth)


def _cone(d, n=8192):
    """A dominant shared direction (norm 5) beside unit random parts: the
    10th-to-33rd score gaps clear the bf16x2 proof bound but not bf16's."""
    rng = np.random.default_rng(d)
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    r = rng.standard_normal((n, d))
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return (5.0 * u[None, :] + r).astype(np.float32)


@pytest.mark.parametrize("d", [512, 1024])
def test_probe_picks_bf16x2_by_margin_alone(monkeypatch, d):
    """The probe answers "bf16x2" wherever the margin picks it, whatever
    the width (before the kernels took any d it could not at 1,024)."""
    monkeypatch.setattr(tdense, "TWO_STAGE_MIN_N", 4096)
    index = DenseIndex(d, metric="ip", device="cpu")
    index.add(_cone(d))
    index.commit()
    assert index._stage1_mode == "bf16x2"
