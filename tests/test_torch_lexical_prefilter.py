"""The hashed-UB lexical prefilter in the port (`ops.lexical_prefilter`,
`BM25Index` / `TfidfIndex` with `prefilter="verified"` / `"fast"`) against
the JAX package's, on the CPU.

Held bit for bit: `assign_buckets`, the bf16 round-up (an upper bound that
is itself a bf16 value), `build_ub_image` and `hash_queries`, and the state
`build_prefilter` makes (term map, bf16 image, largest row norm, unified
ELL), also from an index that the JAX package saved. Held to the lists:
"verified" equals the exact scan (scores to 1e-5 relative: the rescore and
the scan share the per-term f32 chain, bit-equal here), "fast" equals the
JAX package's "fast" (both rescore exactly the same candidates), and the
refusals (negative contributions, the storage gate, a wide ELL) leave the
scan serving, as k above k_scan does.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jlex = importlib.import_module("persian_rag_tpu.index.lexical")
jpf = importlib.import_module("persian_rag_tpu.ops.lexical_prefilter")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")
tpf = importlib.import_module("persian_rag_tpu_torch.ops.lexical_prefilter")


def _mk_corpus(n_docs=320, vocab=500, doc_len=(8, 40), seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(f"t{t}" for t in rng.choice(
        vocab, size=int(rng.integers(*doc_len)), p=p)) for _ in range(n_docs)]


def _expected_topk(dense, k):
    return np.lexsort((np.arange(dense.shape[0]), -dense))[:k]


def test_assign_buckets_and_hash_queries_equal_jax():
    rng = np.random.default_rng(0)
    df = rng.integers(1, 50, 3000)  # many ties: the stable order decides
    for n_buckets, frac in ((1024, 0.5), (64, 0.25), (16, 0.0)):
        np.testing.assert_array_equal(tpf.assign_buckets(df, n_buckets, frac),
                                      jpf.assign_buckets(df, n_buckets, frac))
    tm = tpf.assign_buckets(df, 64)
    qids = rng.integers(-1, 3000, (9, 12)).astype(np.int32)
    qvals = rng.random((9, 12)).astype(np.float32)
    np.testing.assert_array_equal(tpf.hash_queries(qids, qvals, tm, 64),
                                  jpf.hash_queries(qids, qvals, tm, 64))


def test_bf16_round_up_bits():
    rng = np.random.default_rng(1)
    x = np.concatenate([(rng.random(4096).astype(np.float32) * 100) ** 2,
                        np.float32([0.0, 1.0, 3.0, 1e-30, 3.3895314e38])])
    up = tpf._bf16_round_up(x)
    np.testing.assert_array_equal(up.view(np.uint32),
                                  jpf._bf16_round_up(x).view(np.uint32))
    assert (up >= x).all()
    rt = torch.from_numpy(up).bfloat16().float().numpy()
    np.testing.assert_array_equal(rt, up)  # a bf16 value
    near = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_array_equal(up[near >= x], near[near >= x])


@pytest.mark.parametrize("n_buckets", [16, 1024])
def test_build_ub_image_equals_jax(n_buckets):
    rng = np.random.default_rng(2)
    n, l, v = 300, 12, 5000
    ids = rng.integers(0, v, (n, l)).astype(np.int32)
    ids[rng.random((n, l)) < 0.3] = -1
    vals = np.where(ids >= 0, rng.random((n, l)).astype(np.float32) * 9, 0)
    vals = vals.astype(np.float32)
    tm = tpf.assign_buckets(np.bincount(ids[ids >= 0], minlength=v),
                            n_buckets)
    w_t, r_t = tpf.build_ub_image(ids, vals, tm, n_buckets, chunk_rows=64)
    w_j, r_j = jpf.build_ub_image(ids, vals, tm, n_buckets, chunk_rows=64)
    np.testing.assert_array_equal(w_t.view(np.uint32), w_j.view(np.uint32))
    assert r_t == r_j


def _state_equal(t, j):
    tp, jp = t._prefilter, j._prefilter
    assert tp.n_buckets == jp.n_buckets and tp.k_scan == jp.k_scan
    np.testing.assert_array_equal(tp.term_map, jp.term_map)
    np.testing.assert_array_equal(
        tp.w16.float().numpy().view(np.uint32),
        np.asarray(jp.w16.astype(jnp.float32)).view(np.uint32))
    assert tp.w16.dtype == torch.bfloat16
    assert np.float32(tp.row_norm_max) == np.asarray(jp.row_norm_max)
    np.testing.assert_array_equal(tp.uids.numpy(), np.asarray(jp.uids))
    np.testing.assert_array_equal(tp.uvals.numpy().view(np.uint32),
                                  np.asarray(jp.uvals).view(np.uint32))


@pytest.mark.parametrize("cls, n_buckets, k_scan", [
    ("BM25Index", 64, 32), ("BM25Index", 256, 64), ("TfidfIndex", 128, 64)])
def test_verified_equals_scan_and_jax(cls, n_buckets, k_scan):
    docs = _mk_corpus(seed=3)
    queries = ["t1 t3 t7", "t2 t2 t50", "t100 t5", "t1", "t499 t1 t12 t30",
               "zzz t9"]
    j = getattr(jlex, cls)().build(docs)
    t = getattr(tlex, cls)(device="cpu").build(docs)
    base_s, base_i = t.search(queries, 10)
    assert t.build_prefilter(n_buckets=n_buckets, k_scan=k_scan)
    assert j.build_prefilter(n_buckets=n_buckets, k_scan=k_scan)
    _state_equal(t, j)
    for idx in (t, j):
        idx.prefilter = "verified"
    pf_s, pf_i = t.search(queries, 10)
    js, ji = j.search(queries, 10)
    np.testing.assert_array_equal(pf_i, base_i)
    np.testing.assert_array_equal(pf_i, ji)
    np.testing.assert_allclose(pf_s, base_s, rtol=1e-5, atol=1e-6)
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(pf_i[qi],
                                      _expected_topk(t.get_scores(q), 10))


def test_fast_equals_jax_fast():
    docs = _mk_corpus(n_docs=512, vocab=200, seed=11)
    queries = ["t1 t3 t9", "t2 t40", "t5", "t7 t8 t150 t199"]
    j = jlex.BM25Index().build(docs)
    t = tlex.BM25Index(device="cpu").build(docs)
    for idx in (t, j):
        assert idx.build_prefilter(n_buckets=128, k_scan=64)
        idx.prefilter = "fast"
    ts, ti = t.search(queries, 10)
    js, ji = j.search(queries, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
    for qi, q in enumerate(queries):  # exact scores for the returned ids
        np.testing.assert_allclose(ts[qi], t.get_scores(q)[ti[qi]],
                                   rtol=1e-5, atol=1e-6)


def test_proof_passes_on_dedicated_vocab():
    """Every term in a bucket of its own: the image is exact up to bf16
    rounding, and the proof clears on clean margins (tile 128: a pool of
    128 candidates on a small corpus), as in the JAX package."""
    docs = _mk_corpus(n_docs=4096, vocab=100)
    t = tlex.BM25Index(device="cpu").build(docs)
    assert t.build_prefilter(n_buckets=256, k_scan=64)
    pf = t._prefilter
    qids, qvals = t._encode_queries(
        [t._query_terms(q) for q in ["t1 t2 t3", "t5 t9"]])
    qh = tpf.hash_queries(qids, qvals, pf.term_map, pf.n_buckets)
    s, i, ok = tpf.prefilter_topk(
        torch.from_numpy(qh), pf.w16, pf.row_norm_max, pf.uids, pf.uvals,
        torch.from_numpy(qids), torch.from_numpy(qvals), 5, k_scan=64,
        return_ok=True, tile_n=128)
    assert bool(ok.all())
    np.testing.assert_array_equal(i[0].numpy(),
                                  _expected_topk(t.get_scores("t1 t2 t3"), 5))


def test_bucketed_unified_ell_and_saved_by_jax(tmp_path):
    """Several length buckets: the unified ELL holds every bucket row; a
    BM25 index that the JAX package saved gives the port JAX's prefilter
    state bit for bit, and "verified" serves the scan's lists."""
    rng = np.random.default_rng(5)
    docs = [" ".join(f"t{rng.integers(200)}" for _ in range(
        int(rng.choice([4, 20, 90])))) for _ in range(150)]
    j = jlex.BM25Index().build(docs)
    j.save(str(tmp_path / "bm25"))
    t = tlex.BM25Index.load(str(tmp_path / "bm25"), device="cpu")
    assert t._buckets is not None and len(t._buckets) > 1
    ids, vals = t._unified_ell_host()
    jids, jvals = j._unified_ell_host()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vals, jvals)
    base_s, base_i = t.search(["t1 t2", "t7"], 6)
    assert t.build_prefilter(n_buckets=64, k_scan=32)
    assert j.build_prefilter(n_buckets=64, k_scan=32)
    _state_equal(t, j)
    t.prefilter = "verified"
    pf_s, pf_i = t.search(["t1 t2", "t7"], 6)
    np.testing.assert_array_equal(pf_i, base_i)


@pytest.mark.parametrize("case", ["negative", "storage", "wide", "big_k"])
def test_refusals_keep_the_scan(case, monkeypatch):
    if case == "negative":  # every term in every doc: negative idf floor
        docs = ["x x y", "x y", "x y y", "x y x"]
        queries, k = ["x"], 2
    elif case == "wide":
        docs = [" ".join(f"w{i}" for i in range(600))] + _mk_corpus(40)
        queries, k = ["t1 t2"], 5
    else:
        docs = _mk_corpus(n_docs=100, vocab=80, seed=9)
        queries, k = ["t1 t2"], (20 if case == "big_k" else 5)
    if case == "storage":
        monkeypatch.setattr(tlex, "_PREFILTER_STORE_MAX", 0.5)
        monkeypatch.setattr(jlex, "_PREFILTER_STORE_MAX", 0.5)
        docs = docs + [" ".join(f"w{i}" for i in range(300))]
    j = jlex.BM25Index().build(docs)
    t = tlex.BM25Index(device="cpu").build(docs)
    refused = case != "big_k"
    assert t.build_prefilter(n_buckets=32, k_scan=8) is not refused
    assert j.build_prefilter(n_buckets=32, k_scan=8) is not refused
    base = tlex.BM25Index(device="cpu").build(docs)
    t.prefilter = "fast"
    s, i = t.search(queries, k)
    np.testing.assert_array_equal(i, base.search(queries, k)[1])
