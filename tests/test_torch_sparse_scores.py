"""The port's sparse top-k (persian_rag_tpu_torch.ops.sparse_scores)
against the JAX package's, on the CPU.

Inputs come from a numpy seed. The JAX side runs its four Pallas kernels
in interpret mode (tile_n=128, u_chunk=32, as tests/test_sparse_scores.py
does); the port runs each kernel's plain PyTorch version (CPU tensors).

* Dyadic values (multiples of 1/64, small magnitudes) make every f32
  summation order exact, so scores and ids, tie order included, must be
  EQUAL.
* Random float values: scores within rtol 1e-6 / atol 1e-6, and ids equal
  wherever the gap between neighbouring scores exceeds 1e-5 (the union
  kernels and the per-term kernels sum in different orders).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# `persian_rag_tpu.ops.sparse_scores` as an attribute is a FUNCTION (the
# ops package re-exports it): import the modules by path
jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

KERNELS = ("sparse_topk", "sparse_topk_hashed", "sparse_topk_union",
           "sparse_topk_union_hashed")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_corpus(rng, n, el, vocab, dyadic=True, negative=False, dups=()):
    """(N, L) ELL with unique term ids per row, front-contiguous, -1 pad.
    `dups` lists (src, dst) rows to copy (exact score ties)."""
    ids = np.full((n, el), -1, np.int32)
    vals = np.zeros((n, el), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, el + 1))
        ids[d, :nt] = rng.choice(vocab, nt, replace=False)
        if dyadic:
            vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
        else:
            vals[d, :nt] = rng.random(nt).astype(np.float32) * 3
    if negative:
        vals = -np.abs(vals)
    for src, dst in dups:
        ids[dst], vals[dst] = ids[src], vals[src]
    return ids, vals


def make_queries(rng, b, t, vocab, dyadic=True, repeat=True, pad=-1):
    """(B, T) query batch; repeat=True allows duplicate ids in a query
    (their weights sum)."""
    qids = np.full((b, t), pad, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for i in range(b):
        nt = int(rng.integers(1, t + 1))
        qids[i, :nt] = rng.choice(vocab, nt, replace=repeat)
        if dyadic:
            qvals[i, :nt] = rng.integers(1, 128, nt) / 64.0
        else:
            qvals[i, :nt] = rng.random(nt).astype(np.float32) * 2
    return qids, qvals


def jax_kernel(name, ids, vals, qids, qvals, k, s_n):
    """The JAX package's Pallas kernel for `name`, in interpret mode."""
    q = (jnp.asarray(qids), jnp.asarray(qvals))
    if name == "sparse_topk":
        s, i = jss.sparse_topk_pallas(jnp.asarray(ids), jnp.asarray(vals), *q,
                                      k=k, tile_n=128, interpret=True)
    elif name == "sparse_topk_union":
        s, i = jss.sparse_topk_union_pallas(
            jnp.asarray(ids), jnp.asarray(vals), *q, k=k, tile_n=128,
            u_chunk=32, interpret=True)
    else:
        ids3, vals3 = jss.hash_segments(ids, vals, s_n)
        d3 = (jnp.asarray(ids3), jnp.asarray(vals3))
        if name == "sparse_topk_hashed":
            s, i = jss.sparse_topk_hashed_pallas(
                *d3, *q, k=k, tile_n=128, tile_b=8, interpret=True)
        else:
            s, i = jss.sparse_topk_union_hashed_pallas(
                *d3, *q, k=k, tile_n=128, u_chunk=32, interpret=True)
    return np.asarray(s), np.asarray(i)


def port_entry(name, ids, vals, qids, qvals, k, s_n):
    """The port's dispatching entry for `name` on CPU tensors."""
    if name in ("sparse_topk_hashed", "sparse_topk_union_hashed"):
        ids, vals = tss.hash_segments(ids, vals, s_n)
    s, i = getattr(tss, name)(_t(ids), _t(vals), _t(qids), _t(qvals), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


CASES = {
    # n, L, B, T, k, vocab, S
    "basic": (300, 20, 4, 8, 5, 500, 4),
    "shared_terms": (513, 9, 12, 5, 10, 30, 8),
    "tiles": (391, 11, 9, 6, 7, 25, 2),
    "wide": (700, 64, 16, 16, 12, 900, 16),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", KERNELS)
def test_plain_equals_jax_kernel_dyadic(name, case):
    n, el, b, t, k, vocab, s_n = CASES[case]
    rng = np.random.default_rng(10 * KERNELS.index(name) + list(CASES).index(case))
    ids, vals = make_corpus(rng, n, el, vocab, dups=((3, 140), (3, 299)))
    qids, qvals = make_queries(rng, b, t, vocab)
    qids[0, :3] = ids[3, :3]  # query 0 ties rows 3, 140 and 299 exactly
    want_s, want_i = jax_kernel(name, ids, vals, qids, qvals, k, s_n)
    got_s, got_i = port_entry(name, ids, vals, qids, qvals, k, s_n)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("name", KERNELS)
def test_negative_contributions_and_pad_kinds(name):
    """All-negative contributions (floored-idf BM25), N not a tile
    multiple, and -2 query pads (union_prep's) as well as -1."""
    rng = np.random.default_rng(5)
    ids, vals = make_corpus(rng, 391, 11, 60, negative=True)
    for pad in (-1, -2):
        qids, qvals = make_queries(rng, 5, 5, 60, repeat=False, pad=pad)
        want_s, want_i = jax_kernel(name, ids, vals, qids, qvals, 6, 4)
        got_s, got_i = port_entry(name, ids, vals, qids, qvals, 6, 4)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("name", KERNELS)
def test_all_pad_queries_return_lowest_ids(name):
    """Queries with no in-vocabulary term score 0 everywhere and return
    ids 0..k-1, as lax.top_k does."""
    rng = np.random.default_rng(6)
    ids, vals = make_corpus(rng, 150, 5, 30)
    qids = np.full((3, 8), -1, np.int32)
    qvals = np.zeros((3, 8), np.float32)
    want_s, want_i = jax_kernel(name, ids, vals, qids, qvals, 4, 4)
    got_s, got_i = port_entry(name, ids, vals, qids, qvals, 4, 4)
    np.testing.assert_array_equal(got_i, np.tile(np.arange(4), (3, 1)))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    assert (got_s == 0).all()


@pytest.mark.parametrize("name", KERNELS)
def test_random_floats_within_tolerance(name):
    """Float values: scores within 1e-6, ids equal away from near-ties."""
    rng = np.random.default_rng(7)
    ids, vals = make_corpus(rng, 600, 24, 200, dyadic=False)
    qids, qvals = make_queries(rng, 10, 8, 200, dyadic=False)
    k = 10
    want_s, want_i = jax_kernel(name, ids, vals, qids, qvals, k, 8)
    got_s, got_i = port_entry(name, ids, vals, qids, qvals, k, 8)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    gaps = np.abs(np.diff(want_s, axis=1))
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gaps > 1e-5
    clear[:, :-1] &= gaps > 1e-5
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    assert clear.mean() > 0.8


def test_scores_ref_equals_jax():
    rng = np.random.default_rng(8)
    ids, vals = make_corpus(rng, 700, 23, 120)
    qids, qvals = make_queries(rng, 12, 9, 120)
    want = np.asarray(jss.sparse_scores_ref(*map(jnp.asarray,
                                                (ids, vals, qids, qvals))))
    got = tss.sparse_scores_ref(_t(ids), _t(vals), _t(qids), _t(qvals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k_beyond_corpus_clamps():
    rng = np.random.default_rng(9)
    ids, vals = make_corpus(rng, 7, 4, 20)
    qids, qvals = make_queries(rng, 2, 3, 20)
    for name in KERNELS:
        s, i = port_entry(name, ids, vals, qids, qvals, 50, 4)
        assert s.shape == (2, 7) and sorted(i[0]) == list(range(7))


@pytest.mark.parametrize("n_segments", [2, 4, 8, 16])
def test_hash_segments_equal_jax(n_segments):
    rng = np.random.default_rng(10)
    ids, vals = make_corpus(rng, 300, 37, 500)
    want = jss.hash_segments(ids, vals, n_segments)
    got = tss.hash_segments(ids, vals, n_segments)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("u_chunk", [16, 32, 64])
@pytest.mark.parametrize("vocab", [12, 40, 5000])
def test_union_prep_equals_jax(u_chunk, vocab):
    rng = np.random.default_rng(u_chunk + vocab)
    qids, qvals = make_queries(rng, 13, 9, vocab)
    qids[5] = -1  # an all-pad query
    want = jss.union_prep(jnp.asarray(qids), jnp.asarray(qvals), u_chunk)
    got = tss.union_prep(_t(qids), _t(qvals), u_chunk)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("u_chunk", [16, 32])
@pytest.mark.parametrize("n_segments", [1, 4, 8, 16])
def test_union_prep_hashed_equals_jax(u_chunk, n_segments):
    rng = np.random.default_rng(u_chunk * n_segments)
    qids, qvals = make_queries(rng, 11, 7, 60)
    want = jss.union_prep_hashed(jnp.asarray(qids), jnp.asarray(qvals),
                                 u_chunk, n_segments)
    got = tss.union_prep_hashed(_t(qids), _t(qvals), u_chunk, n_segments)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_union_prep_all_pad_batch():
    qids = np.full((4, 8), -1, np.int32)
    qvals = np.zeros((4, 8), np.float32)
    u_ids, qw, n_chunks = tss.union_prep(_t(qids), _t(qvals), 32)
    assert int(n_chunks) == 0 and (u_ids.numpy() == -2).all()
    assert (qw.numpy() == 0).all()
    _, _, seg, n_chunks = tss.union_prep_hashed(_t(qids), _t(qvals), 32, 8)
    assert int(n_chunks) == 0 and seg.shape == (1, 1 + 8)


def test_entries_refuse_other_devices():
    ids = torch.zeros((10, 4), dtype=torch.int32, device="meta")
    vals = torch.zeros((10, 4), device="meta")
    q = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    qv = torch.zeros((2, 3), device="meta")
    for name in ("sparse_topk", "sparse_topk_union"):
        with pytest.raises(ValueError, match="device type meta"):
            getattr(tss, name)(ids, vals, q, qv, 3)
    ids3 = ids.view(10, 2, 2)
    vals3 = vals.view(10, 2, 2)
    for name in ("sparse_topk_hashed", "sparse_topk_union_hashed"):
        with pytest.raises(ValueError, match="device type meta"):
            getattr(tss, name)(ids3, vals3, q, qv, 3)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the CUDA wrappers raise (the entries take the plain
    version there); no launch is counted."""
    rng = np.random.default_rng(11)
    ids, vals = make_corpus(rng, 40, 4, 20)
    qids, qvals = make_queries(rng, 2, 3, 20)
    ids3, vals3 = tss.hash_segments(ids, vals, 2)
    before = {n: f.launches for n, f in tss.KERNELS.items()}
    for name, fn in tss.KERNELS.items():
        docs = (ids3, vals3) if "hashed" in name else (ids, vals)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*map(_t, docs), _t(qids), _t(qvals), 3)
    assert {n: f.launches for n, f in tss.KERNELS.items()} == before
