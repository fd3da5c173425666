"""parallel/sharded_lexical.py and the lexical indexes' mesh branches of
the port against the JAX package's, on the CPU.

On dyadic ELLs (every f32 sum exact) the port's sharded search equals the
JAX package's sharded search on conftest's 8 virtual CPU devices and the
port's single-device search bit for bit, ids and tie order included:
flat, bucketed (k past a bucket's rows) and wide rows, whose shards take
the hashed-segment layout in the port (the JAX mesh path keeps them
flat); per-term and union kernels; negative contributions (ELL pad rows
score 0 and must not displace them); duplicate rows in different shards.
Real BM25 text through `RetrievalSystem(mesh=)` equals the single-device
system.
"""
import importlib

import jax
import numpy as np
import pytest

from persian_rag_tpu.core.mesh import build_mesh as jbuild
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.parallel import sharded_lexical as tsl

jlex = importlib.import_module("persian_rag_tpu.index.lexical")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

VOCAB = 2000


def _meshes(shards):
    return (jbuild(shards, 1, devices=jax.devices()[:shards]),
            build_mesh(shards, 1, devices=["cpu"] * shards))


def _dyadic_ell(rng, n, widths, negative=False):
    """Front-contiguous ELL, unique ids per row, dyadic values; rows 5,
    n // 2 + 1 and n - 1 duplicate row 2 (exact ties across shards)."""
    el = max(widths)
    ids = np.full((n, el), -1, np.int32)
    vals = np.zeros((n, el), np.float32)
    for d in range(n):
        nt = int(rng.choice(widths))
        nt = int(rng.integers(max(1, nt // 2), nt + 1))
        ids[d, :nt] = rng.choice(VOCAB, nt, replace=False)
        vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
    if negative:
        vals = -vals
    for dst in (5, n // 2 + 1, n - 1):
        ids[dst], vals[dst] = ids[2], vals[2]
    return ids, vals


def _terms(rng, ids, b=24, t=12):
    out = []
    for i in range(b):
        nt = 0 if i == 1 else int(rng.integers(1, t + 1))  # 1: no terms
        tids = rng.choice(VOCAB, nt, replace=False)
        out.append([(int(x), float(rng.integers(1, 128) / 64.0))
                    for x in tids])
    out[0] = [(int(x), 1.0) for x in ids[2, :3] if x >= 0]
    return out


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of each sparse plain version the port runs."""
    calls = {}
    for name in ("sparse_topk", "sparse_topk_hashed", "sparse_topk_union",
                 "sparse_topk_union_hashed"):
        plain = getattr(tss, name + "_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **kw)

        monkeypatch.setattr(tss, name + "_plain", counted)
    return calls


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("batch_kernel", [None, "union"])
@pytest.mark.parametrize("layout", ["flat", "bucketed", "wide", "negative"])
def test_sharded_search_equals_jax_dyadic(kernel_calls, layout, batch_kernel,
                                          shards):
    rng = np.random.default_rng(11 + len(layout))
    widths = {"flat": (24,), "bucketed": (6, 20, 40), "wide": (8, 100),
              "negative": (6, 20)}[layout]
    ids, vals = _dyadic_ell(rng, 400, widths, negative=layout == "negative")
    jm, tm = _meshes(shards)
    j = jlex.BM25Index(mesh=jm)
    t = tlex.BM25Index(mesh=tm)
    one = tlex.BM25Index(device="cpu")
    for index in (j, t, one):
        index._set_ell_auto(ids, vals)
        index.batch_kernel = batch_kernel
    terms = _terms(rng, ids)
    want_s, want_i = j._search_encoded(terms, 10)
    got_s, got_i = t._search_encoded(terms, 10)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    one_s, one_i = one._search_encoded(terms, 10)
    np.testing.assert_array_equal(got_i, one_i)
    np.testing.assert_array_equal(got_s, one_s)
    if layout != "negative":
        np.testing.assert_array_equal(got_i[0, :3], [2, 5, 201])
    if batch_kernel == "union":
        assert set(kernel_calls) & {"sparse_topk_union",
                                    "sparse_topk_union_hashed"}
    else:
        assert not set(kernel_calls) & {"sparse_topk_union",
                                        "sparse_topk_union_hashed"}
    if layout == "wide":
        # wide shards take the hashed layout, as a corpus of their size
        # would alone
        shards_of = (t._shards if t._buckets is None
                     else [s for b in t._buckets for s in b.shards])
        assert any(layout_[0].dim() == 3 for layout_, _ in shards_of)


def test_bucketed_k_past_a_bucket():
    """Buckets of fewer than 30 wide rows and k = 30: their top-k is all
    they have, the merge fills the rest by (score, id)."""
    rng = np.random.default_rng(5)
    ids, vals = _dyadic_ell(rng, 300, (10,))
    wide_ids, wide_vals = _dyadic_ell(rng, 10, (40,))
    ids = np.concatenate([np.pad(ids, ((0, 0), (0, 30)), constant_values=-1),
                          wide_ids])
    vals = np.concatenate([np.pad(vals, ((0, 0), (0, 30))), wide_vals])
    jm, tm = _meshes(4)
    j, t = jlex.BM25Index(mesh=jm), tlex.BM25Index(mesh=tm)
    one = tlex.BM25Index(device="cpu")
    for index in (j, t, one):
        index._set_ell_auto(ids, vals)
    assert min(b.n_actual for b in t._buckets) < 30
    terms = _terms(rng, ids, b=9)
    got = t._search_encoded(terms, 30)
    want = j._search_encoded(terms, 30)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], one._search_encoded(terms, 30)[1])


def test_shard_ell_pads_with_id_minus_one():
    ids = np.arange(10, dtype=np.int32).reshape(5, 2)
    vals = np.ones((5, 2), np.float32)
    _, tm = _meshes(4)
    parts, n = tsl.shard_ell(ids, vals, tm)
    assert n == 5 and [p[0].shape for p in parts] == [(2, 2)] * 4
    np.testing.assert_array_equal(parts[3][0], [[-1, -1], [-1, -1]])
    np.testing.assert_array_equal(parts[2][1], [[1, 1], [0, 0]])


@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_text_index_on_mesh_equals_single(kind):
    from test_torch_lexical import persian_texts, zipf_texts

    rng = np.random.default_rng(4)
    texts = persian_texts(rng, 250, 4, 40) + zipf_texts(rng, 100, 5, 30)
    texts[200] = texts[3]
    cls = tlex.BM25Index if kind == "bm25" else tlex.TfidfIndex
    _, tm = _meshes(8)
    t = cls(mesh=tm).build(texts)
    one = cls(device="cpu").build(texts)
    assert t.build_prefilter() is False  # the prefilter is single-device
    queries = persian_texts(rng, 20, 1, 6) + [texts[3]]
    for index in (t, one):
        index.batch_kernel = "flat"  # one summation order on both sides
    got, want = t.search(queries, 10), one.search(queries, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.get_scores(queries[0]),
                               one.get_scores(queries[0]), rtol=0, atol=0)
