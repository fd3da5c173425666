"""Two-pass union serving in the port (`sparse_topk_union_twopass` and
`BM25Index(two_pass="auto")`) against the JAX package's, on the CPU.

The JAX side runs its kernels in interpret mode (`use_pallas=True`); the
port's entries take their plain versions on CPU tensors. Held:

* the served lists (ids, and scores to 2e-6 relative: both rescore with
  the per-term f32 chain, or both fall back to an exact union kernel) equal
  JAX's and the dense f32 reference's, flat and over a hashed copy, on
  random and dyadic corpora;
* the per-query proof verdicts equal JAX's, with and without the batch's
  union count (which never passes fewer queries), the fallback on more
  tied documents than k_scan, and the zero cut of all-OOV / empty queries;
* at the index: the routing with the gate lowered (monkeypatch, as the
  JAX test does) serves JAX's lists through stage 1, the sticky demotion
  after TWOPASS_DEMOTE_STREAK failing dispatches and its reset on a build,
  and the gates that keep a batch off two-pass (negative weights, k above
  _TWOPASS_MAX_K, two_pass="off").
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jlex = importlib.import_module("persian_rag_tpu.index.lexical")
jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _random_ell(rng, n, l, vocab, dyadic=False, zipf=1.3):
    """Front-contiguous nonnegative ELL, Zipf-ish term ids."""
    ids = np.full((n, l), -1, np.int32)
    vals = np.zeros((n, l), np.float32)
    for d in range(n):
        nt = rng.integers(3, l + 1)
        tids = np.unique((rng.zipf(zipf, nt * 2) - 1).clip(0, vocab - 1)
                         )[:nt].astype(np.int32)
        ids[d, :len(tids)] = tids
        vals[d, :len(tids)] = (
            rng.integers(32, 256, len(tids)) / 64.0 if dyadic
            else rng.uniform(0.5, 4.0, len(tids)))
    return ids, vals


def _queries(rng, b, t, vocab):
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for i in range(b):
        nt = rng.integers(2, t + 1)
        tids = np.unique((rng.zipf(1.3, nt * 2) - 1).clip(0, vocab - 1)
                         )[:nt].astype(np.int32)
        qids[i, :len(tids)] = tids
        qvals[i, :len(tids)] = rng.uniform(0.5, 2.0, len(tids))
    return qids, qvals


def _ref_topk(ids, vals, qids, qvals, k):
    scores = np.asarray(jss.sparse_scores_ref(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(qids),
        jnp.asarray(qvals)))
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, 1), order.astype(np.int32)


def _both(ids, vals, ids3, vals3, qids, qvals, k, n_union=None):
    js, ji, jok = jss.sparse_topk_union_twopass(
        jnp.asarray(ids), jnp.asarray(vals),
        None if ids3 is None else jnp.asarray(ids3),
        None if ids3 is None else jnp.asarray(vals3),
        jnp.asarray(qids), jnp.asarray(qvals), k, use_pallas=True,
        return_ok=True,
        n_union=None if n_union is None else jnp.float32(n_union))
    ts, ti, tok = tss.sparse_topk_union_twopass(
        _t(ids), _t(vals), None if ids3 is None else _t(ids3),
        None if ids3 is None else _t(vals3), _t(qids), _t(qvals), k,
        n_union=n_union, return_ok=True)
    return ((np.asarray(js), np.asarray(ji), np.asarray(jok)),
            (ts.numpy(), ti.numpy(), tok.numpy()))


def _hold(jax_out, port_out, ids, vals, qids, qvals, k):
    (js, ji, jok), (ts, ti, tok) = jax_out, port_out
    rs, ri = _ref_topk(ids, vals, qids, qvals, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_allclose(ts, js, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(ts, rs, rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(tok, jok)
    assert ts.dtype == np.float32 and ti.dtype == np.int32


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("segments", [0, 4])
def test_twopass_equals_jax(dyadic, segments):
    rng = np.random.default_rng(10 + segments + dyadic)
    n, l, vocab, b, t, k = 700, 12, 400, 24, 8, 5
    ids, vals = _random_ell(rng, n, l, vocab, dyadic)
    ids3 = vals3 = None
    if segments:
        ids3, vals3 = tss.hash_segments(ids, vals, segments)
    qids, qvals = _queries(rng, b, t, vocab)
    jax_out, port_out = _both(ids, vals, ids3, vals3, qids, qvals, k)
    _hold(jax_out, port_out, ids, vals, qids, qvals, k)
    assert port_out[2].mean() > 0.5  # most queries proven


def test_twopass_n_union_bound_still_exact():
    rng = np.random.default_rng(6)
    n, l, vocab, b, t, k = 700, 12, 400, 24, 8, 5
    ids, vals = _random_ell(rng, n, l, vocab)
    qids, qvals = _queries(rng, b, t, vocab)
    n_u = len(np.unique(qids[qids >= 0]))
    jax_out, port_out = _both(ids, vals, None, None, qids, qvals, k, n_u)
    _hold(jax_out, port_out, ids, vals, qids, qvals, k)
    _, loose = _both(ids, vals, None, None, qids, qvals, k)
    assert port_out[2].sum() >= loose[2].sum()


def test_twopass_falls_back_on_ties():
    """80 identical rows (more than k_scan = 32) on terms only they hold:
    no query's proof clears its cut, and the batch is served by the exact
    union kernel, duplicates lowest id first."""
    rng = np.random.default_rng(2)
    n, l, vocab, b, t, k = 400, 6, 50, 8, 4, 5
    ids, vals = _random_ell(rng, n, l, vocab)
    plant = rng.choice(n, 80, replace=False)
    ids[plant] = np.array([60, 61, 62, -1, -1, -1], np.int32)
    vals[plant] = np.array([2.0, 1.5, 1.0, 0, 0, 0], np.float32)
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    qids[:, :3] = [60, 61, 62]
    qvals[:, :3] = 1.0
    jax_out, port_out = _both(ids, vals, None, None, qids, qvals, k)
    assert not port_out[2].any()
    _hold(jax_out, port_out, ids, vals, qids, qvals, k)


def test_twopass_zero_cut_is_proven():
    rng = np.random.default_rng(5)
    n, l, vocab, b, t, k = 500, 8, 300, 8, 6, 5
    ids, vals = _random_ell(rng, n, l, vocab)
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    qids[:b // 2, :2] = [vocab + 7, vocab + 9]  # half all-OOV, half empty
    qvals[:b // 2, :2] = 1.0
    jax_out, port_out = _both(ids, vals, None, None, qids, qvals, k)
    assert port_out[2].all()
    _hold(jax_out, port_out, ids, vals, qids, qvals, k)
    np.testing.assert_array_equal(port_out[1], np.tile(np.arange(k), (b, 1)))


def _docs(rng, n, vocab_size=120, words=60):
    vocab = [f"w{j}" for j in range(vocab_size)]
    return [" ".join(rng.choice(vocab[:words], rng.integers(4, 9),
                                replace=False)) for _ in range(n)], vocab


def _count_twopass(monkeypatch):
    calls = []
    orig = tlex.sparse_topk_union_twopass

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tlex, "sparse_topk_union_twopass", counted)
    return calls


def test_index_gate_routes_and_matches_jax(monkeypatch):
    """With _TWOPASS_MIN_N lowered in both packages, two_pass="auto" on a
    vocabulary-sharing batch serves the JAX index's lists through stage 1
    (flat and bucketed corpora), and equals two_pass="off"."""
    monkeypatch.setattr(jlex, "_TWOPASS_MIN_N", 1)
    monkeypatch.setattr(tlex, "_TWOPASS_MIN_N", 1)
    calls = _count_twopass(monkeypatch)
    rng = np.random.default_rng(3)
    docs, vocab = _docs(rng, 300)
    docs += [" ".join(rng.choice(vocab[:60], 40)) for _ in range(30)]
    queries = [" ".join(rng.choice(vocab[:30], 3, replace=False))
               for _ in range(16)]
    for corpus in (docs[:300], docs):
        j = jlex.BM25Index().build(corpus)
        t = tlex.BM25Index(device="cpu").build(corpus)
        assert (j._buckets is None) == (t._buckets is None)
        for idx in (j, t):
            idx.batch_kernel = "union"
            idx.two_pass = "auto"
        before = len(calls)
        js, ji = j.search(queries, k=5)
        ts, ti = t.search(queries, k=5)
        assert len(calls) > before
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=2e-6, atol=1e-6)
        t.two_pass = "off"
        off_s, off_i = t.search(queries, k=5)
        np.testing.assert_array_equal(off_i, ti)


def test_sticky_demotion_and_reset(monkeypatch):
    """Batches whose queries all fail the proof (80 identical documents
    matching them) demote two-pass after TWOPASS_DEMOTE_STREAK dispatches,
    as the JAX index does, serving exact lists throughout; a build resets
    the verdict."""
    monkeypatch.setattr(jlex, "_TWOPASS_MIN_N", 1)
    monkeypatch.setattr(tlex, "_TWOPASS_MIN_N", 1)
    calls = _count_twopass(monkeypatch)
    rng = np.random.default_rng(7)
    vocab = [f"w{j}" for j in range(40)]
    docs = ["w0 w1 w2"] * 80 + [" ".join(rng.choice(vocab[3:], 5,
                                                    replace=False))
                                for _ in range(240)]
    j = jlex.BM25Index().build(docs)
    t = tlex.BM25Index(device="cpu").build(docs)
    for idx in (j, t):
        idx.batch_kernel = "union"
        idx.two_pass = "auto"
    assert t.TWOPASS_DEMOTE_STREAK == j.TWOPASS_DEMOTE_STREAK == 3
    for step in range(t.TWOPASS_DEMOTE_STREAK):
        assert not t._twopass_demoted
        js, ji = j.search(["w0 w1 w2"] * 16, k=5)
        ts, ti = t.search(["w0 w1 w2"] * 16, k=5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=2e-6, atol=1e-6)
        assert t._twopass_fail_streak == j._twopass_fail_streak == step + 1
    assert t._twopass_demoted and j._twopass_demoted
    n_calls = len(calls)
    ts, ti = t.search(["w0 w1 w2"] * 16, k=5)
    assert len(calls) == n_calls  # demoted: the exact kernels serve
    np.testing.assert_array_equal(ti, ji)
    t.build(docs)
    assert not t._twopass_demoted and t._twopass_fail_streak == 0


@pytest.mark.parametrize("case", ["negative", "big_k", "off"])
def test_gates_keep_batches_off_two_pass(monkeypatch, case):
    monkeypatch.setattr(tlex, "_TWOPASS_MIN_N", 1)
    calls = _count_twopass(monkeypatch)
    rng = np.random.default_rng(9)
    docs, vocab = _docs(rng, 200)
    t = tlex.BM25Index(device="cpu").build(docs)
    t.batch_kernel = "union"
    t.two_pass = "off" if case == "off" else "auto"
    k = tlex._TWOPASS_MAX_K + 1 if case == "big_k" else 5
    if case == "negative":
        ids, vals = t.doc_ids, t.doc_vals.copy()
        vals[0, 0] = -0.5
        t._set_ell(ids, vals)
        assert t._nonneg is False
    queries = [" ".join(rng.choice(vocab[:30], 3, replace=False))
               for _ in range(16)]
    s, i = t.search(queries, k=k)
    assert not calls and i.shape == (16, k)
    if case != "negative":
        t.two_pass = "auto"
        t.search(queries, k=5)
        assert calls
