"""The port's lexical indexes (persian_rag_tpu_torch.index.lexical) against
the JAX package's, on the CPU.

* Builds: BM25 (the JAX `_build_python`) and TF-IDF produce the same
  vocabulary, idf, buckets, global ids, ELL arrays and device layout
  choice (flat or hashed primary, with or without a union-hash copy).
* Routing: the union gate and the hashed-union work model give the same
  verdicts, so each batch reaches the same kernel.
* Search: on dyadic ELLs (every f32 sum exact) the port equals the JAX
  package's Pallas kernels (interpret mode) exactly, ids and tie order
  included, for every routed kernel; on real BM25 / TF-IDF text, scores
  agree within rtol 1e-6 / atol 1e-6 and ids wherever neighbouring scores
  are more than 1e-5 apart.
* State: the port loads indexes the JAX package saved and searches them
  identically.
"""
import importlib

import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.core.mesh import build_mesh

jlex = importlib.import_module("persian_rag_tpu.index.lexical")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

WORDS = ("دارو درمان بیماری پزشک قلب خون فشار دیابت کودک مادر تغذیه ورزش "
         "خواب درد معده کبد کلیه عفونت قرص آزمایش تشخیص پیشگیری پوست چشم "
         "دندان استخوان تب سرفه ویتامین آهن چاقی اضطراب حافظه بارداری "
         "قانون تاریخ دانشگاه شعر حافظ شهر خانه اقتصاد").split()


def zipf_texts(rng, n, lo, hi, vocab=400):
    return [
        " ".join(map(str, rng.zipf(1.4, size=rng.integers(lo, hi)) % vocab))
        for _ in range(n)
    ]


def wide_texts(rng, n, lo, hi, vocab=3000):
    """Docs of lo..hi distinct terms: one width-128 bucket whose ELL takes
    the hashed-segment primary layout."""
    return [" ".join(map(str, rng.choice(vocab, rng.integers(lo, hi),
                                         replace=False))) for _ in range(n)]


def persian_texts(rng, n, lo, hi):
    words = np.asarray(WORDS)
    return [" ".join(words[rng.integers(0, len(words), rng.integers(lo, hi))])
            for _ in range(n)]


CORPORA = {
    "flat": lambda rng: wide_texts(rng, 120, 20, 31),
    "bucketed": lambda rng: zipf_texts(rng, 300, 5, 80),
    "wide": lambda rng: wide_texts(rng, 150, 70, 121) + zipf_texts(rng, 40, 3, 9),
    "persian": lambda rng: persian_texts(rng, 200, 4, 40),
}


def _layout(index):
    """(ndim of the primary, union-copy shape or None) per bucket."""
    if index._buckets is None:
        pairs = [(index._dev_ids, index._dev_ids3)]
    else:
        pairs = [(b.dev_ids, b.dev_ids3) for b in index._buckets]
    return [(np.asarray(p).ndim, None if u is None else tuple(u.shape))
            for p, u in pairs]


def assert_same_arrays(j, t):
    assert j.vocab == t.vocab and j.ntotal == t.ntotal
    assert (j._buckets is None) == (t._buckets is None)
    if j._buckets is None:
        np.testing.assert_array_equal(t.doc_ids, j.doc_ids)
        np.testing.assert_array_equal(t.doc_vals, j.doc_vals)
    else:
        assert len(j._buckets) == len(t._buckets)
        for a, b in zip(j._buckets, t._buckets):
            for x, y in ((a.ids, b.ids), (a.vals, b.vals), (a.gids, b.gids)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(y, x)
    assert _layout(t) == _layout(j)


def build_pair(kind, texts, **kw):
    if kind == "bm25":
        return (jlex.BM25Index()._build_python(texts),
                tlex.BM25Index(device="cpu").build(texts))
    return (jlex.TfidfIndex(**kw).build(texts), tlex.TfidfIndex(device="cpu", **kw).build(texts))


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_build_equals_jax(kind, corpus):
    texts = CORPORA[corpus](np.random.default_rng(len(corpus)))
    kw = {"max_features": 500} if kind == "tfidf" else {}
    j, t = build_pair(kind, texts, **kw)
    assert_same_arrays(j, t)
    if kind == "bm25":
        assert t.idf.keys() == j.idf.keys()
        assert all(t.idf[w] == j.idf[w] for w in j.idf)
        assert t._avgdl == j._avgdl
    else:
        np.testing.assert_array_equal(t._idf, j._idf)
    if corpus == "wide" and kind == "bm25":
        assert any(nd == 3 for nd, _ in _layout(t))  # hashed primary


def test_set_ell_auto_equals_jax():
    rng = np.random.default_rng(1)
    j = jlex.BM25Index()._build_python(zipf_texts(rng, 200, 5, 60))
    ids = np.full((j.ntotal, 64), -1, np.int32)
    vals = np.zeros((j.ntotal, 64), np.float32)
    for b in j._buckets:
        ids[b.gids, : b.ids.shape[1]] = b.ids
        vals[b.gids, : b.vals.shape[1]] = b.vals
    ja, ta = jlex.BM25Index(), tlex.BM25Index(device="cpu")
    ja._set_ell_auto(ids, vals)
    ta._set_ell_auto(ids, vals)
    ja.vocab = ta.vocab = {}
    assert_same_arrays(ja, ta)


@pytest.fixture
def union_hash_open(monkeypatch):
    """Open the union-hash copy gate in both packages (the tiny corpora
    here are below its TPU-measured N threshold)."""
    for mod in (jlex, tlex):
        monkeypatch.setattr(mod, "_UNION_HASH_MIN_N", 50)
        monkeypatch.setattr(mod, "_UNION_HASH_MIN_L", 4)


@pytest.fixture
def hashed_union_forced(monkeypatch, union_hash_open):
    """Also pass the per-batch hashed-union work model in both packages
    (tiny unions fail it), so union batches reach the hashed-union
    kernel wherever a bucket has the copy."""
    for mod in (jlex, tlex):
        monkeypatch.setattr(
            mod._EllIndex, "_hash_work_ok",
            staticmethod(lambda uids, l_pad, ids3: ids3 is not None))


@pytest.fixture
def plain_calls(monkeypatch):
    """Count which kernel's plain version each search ran."""
    calls = {name: 0 for name in tss.PLAIN}
    for name in tss.PLAIN:
        fn = getattr(tss, f"{name}_plain")

        def spy(*a, _name=name, _fn=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tss, f"{name}_plain", spy)
    return calls


def test_routing_verdicts_equal_jax(union_hash_open):
    rng = np.random.default_rng(2)
    texts = zipf_texts(rng, 260, 5, 40) + wide_texts(rng, 30, 70, 100, 400)
    j, t = build_pair("bm25", texts)
    assert _layout(t) == _layout(j)
    for b, lo, hi in ((4, 2, 6), (64, 8, 17), (200, 5, 12), (130, 1, 3)):
        queries = zipf_texts(rng, b, lo, hi)
        terms = [t._query_terms(q) for q in queries]
        qids, _ = t._encode_queries(terms)
        jq, _ = j._encode_queries([j._query_terms(q) for q in queries])
        np.testing.assert_array_equal(qids, jq)
        assert t._union_gate(qids) == j._union_gate(jq)
        assert t._hash_ok_flags(qids) == j._hash_ok_flags(jq)


def _dyadic_ell(rng, n, vocab, widths):
    """Front-contiguous (N, max width) ELL with unique ids per row, dyadic
    values and rows 5 / 77 / n-1 duplicating row 2 (exact ties)."""
    el = max(widths)
    ids = np.full((n, el), -1, np.int32)
    vals = np.zeros((n, el), np.float32)
    for d in range(n):
        nt = int(rng.choice(widths))
        nt = int(rng.integers(max(1, nt // 2), nt + 1))
        ids[d, :nt] = rng.choice(vocab, nt, replace=False)
        vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
    for dst in (5, 77, n - 1):
        ids[dst], vals[dst] = ids[2], vals[2]
    return ids, vals


def _dyadic_terms(rng, ids, b, t, vocab):
    out = []
    for i in range(b):
        nt = 0 if i == 1 else int(rng.integers(1, t + 1))  # 1: no terms
        tids = rng.choice(vocab, nt, replace=False)
        out.append([(int(x), float(rng.integers(1, 128) / 64.0)) for x in tids])
    out[0] = [(int(x), 1.0) for x in ids[2, :3] if x >= 0]  # ties rows 2, 5, 77
    return out


@pytest.mark.parametrize("batch_kernel", [None, "flat", "union"])
@pytest.mark.parametrize("layout", ["flat", "bucketed", "hashed"])
def test_search_equals_jax_kernels_dyadic(hashed_union_forced, plain_calls,
                                          batch_kernel, layout):
    """Every routed kernel, against the JAX package's Pallas kernels."""
    rng = np.random.default_rng(3 + len(layout))
    vocab = 2000
    widths = {"flat": (24,), "bucketed": (6, 20, 40), "hashed": (8, 100)}[layout]
    ids, vals = _dyadic_ell(rng, 400, vocab, widths)
    j, t = jlex.BM25Index(), tlex.BM25Index(device="cpu")
    j._set_ell_auto(ids, vals)
    t._set_ell_auto(ids, vals)
    assert _layout(t) == _layout(j)
    j.batch_kernel = t.batch_kernel = batch_kernel
    terms = _dyadic_terms(rng, ids, 24, 12, vocab)
    want_s, want_i = j._search_encoded(terms, 10, use_pallas=True)
    got_s, got_i = t._search_encoded(terms, 10)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    np.testing.assert_array_equal(got_i[0, :3], [2, 5, 77])
    np.testing.assert_array_equal(got_i[1], np.arange(10))
    ran = {k for k, v in plain_calls.items() if v}
    if batch_kernel == "union":
        assert ran <= {"sparse_topk_union", "sparse_topk_union_hashed"}
        assert "sparse_topk_union_hashed" in ran
    else:
        assert ran <= {"sparse_topk", "sparse_topk_hashed"}
        assert ("sparse_topk_hashed" in ran) == (layout == "hashed")


@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_text_search_matches_jax(kind):
    """Real BM25 / TF-IDF scores (not dyadic) through the auto gates, with
    duplicate documents; get_scores too."""
    rng = np.random.default_rng(4)
    texts = persian_texts(rng, 250, 4, 40) + zipf_texts(rng, 100, 5, 30)
    texts[40] = texts[3]
    texts[200] = texts[3]
    j, t = build_pair(kind, texts)
    queries = persian_texts(rng, 30, 1, 6) + [texts[3], "نامعلوم"]
    want_s, want_i = j.search(queries, 10)
    got_s, got_i = t.search(queries, 10)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    gaps = np.abs(np.diff(want_s, axis=1))
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= gaps > 1e-5
    clear[:, :-1] &= gaps > 1e-5
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    assert clear.mean() > 0.5
    # the duplicates tie exactly and keep the lower id first
    dup = got_i[len(queries) - 2]
    pos = [list(dup).index(d) for d in (3, 40, 200)]
    assert pos == sorted(pos) and pos[-1] - pos[0] == 2
    np.testing.assert_array_equal(got_i[-1], np.arange(10))  # no known term
    for q in queries[:5]:
        np.testing.assert_allclose(t.get_scores(q), j.get_scores(q),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("corpus", ["flat", "bucketed"])
@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_loads_index_saved_by_jax(tmp_path, kind, corpus):
    rng = np.random.default_rng(5)
    texts = CORPORA[corpus](rng)
    j = (jlex.BM25Index()._build_python(texts) if kind == "bm25"
         else jlex.TfidfIndex().build(texts))
    path = str(tmp_path / kind)
    j.save(path)
    cls = tlex.BM25Index if kind == "bm25" else tlex.TfidfIndex
    t = cls.load(path, device="cpu")
    assert_same_arrays(j, t)
    queries = zipf_texts(rng, 12, 2, 8) if corpus == "bucketed" else [
        texts[i][:40] for i in range(12)]
    want_s, want_i = j.search(queries, 8)
    got_s, got_i = t.search(queries, 8)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_i, want_i)
    # and the JAX package loads what the port saves
    t.save(str(tmp_path / "again"))
    back = type(j).load(str(tmp_path / "again"))
    assert_same_arrays(back, t)


def test_unported_options_raise():
    """A mesh is the lexical option left unported; the native builder,
    the prefilter modes and two-pass serving now run (their own tests:
    test_torch_native_lexical, test_torch_lexical_prefilter,
    test_torch_lexical_twopass) and serve the exact scan's ids here."""
    texts = zipf_texts(np.random.default_rng(6), 30, 3, 9)
    # a mesh is ported (tests/test_torch_sharded_lexical.py): a non-Mesh
    # raises, and a mesh index serves these ids too
    with pytest.raises(TypeError, match="Mesh"):
        tlex.BM25Index(mesh=object(), device="cpu")
    index = tlex.BM25Index(device="cpu").build(texts, use_native=True)
    want = index.search(["1 2"], 3)[1]
    for attr, value in (("prefilter", "verified"), ("prefilter", "fast"),
                        ("two_pass", "auto")):
        setattr(index, attr, value)
        np.testing.assert_array_equal(index.search(["1 2"], 3)[1], want)
        setattr(index, attr, None if attr == "prefilter" else "off")
    assert index.search(["1 2"], 3)[1].shape == (1, 3)
    sharded = tlex.BM25Index(mesh=build_mesh(
        3, 1, devices=["cpu"] * 3)).build(texts, use_native=True)
    np.testing.assert_array_equal(sharded.search(["1 2"], 3)[1], want)
    assert torch.get_default_dtype() == torch.float32
