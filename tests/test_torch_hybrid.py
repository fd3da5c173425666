"""The port's BM25 / TF-IDF / hybrid retrieval slice as a whole against the
JAX package's, on the CPU.

The same converted encoder weights, chunks and queries go through the JAX
RetrievalSystem and the port's. Hybrid fusion runs in f32 on both devices
paths and in float64 on the host loops, so scores agree within rtol 1e-5
and ids wherever neighbouring fused scores are more than 1e-5 apart or
tie exactly (exact ties keep the dense-first, rank order in both). The
cases mirror tests/test_hybrid_fused.py: rerank on and off, non-default
weights, k beyond the corpus, the cosine metric, the rerank provenance
gate, the forced union kernel and the fusion's dedup.
"""
import importlib
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from persian_rag_tpu.retrieval.system import RetrievalSystem as JaxRetrieval
from persian_rag_tpu.serve.api import RetrievalServer as JaxServer

from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
from persian_rag_tpu_torch.serve.api import RetrievalServer

jhf = importlib.import_module("persian_rag_tpu.ops.hybrid_fusion")
thf = importlib.import_module("persian_rag_tpu_torch.ops.hybrid_fusion")
jlex = importlib.import_module("persian_rag_tpu.index.lexical")
tlex = importlib.import_module("persian_rag_tpu_torch.index.lexical")

SMALL = dict(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
WORDS = ("دارو درمان بیماری پزشک قلب خون فشار دیابت کودک مادر تغذیه ورزش "
         "خواب درد معده کبد کلیه عفونت قرص آزمایش تشخیص پیشگیری پوست چشم "
         "دندان استخوان تب سرفه ویتامین آهن چاقی اضطراب حافظه بارداری "
         "قانون تاریخ دانشگاه شعر حافظ شهر خانه اقتصاد واکسن").split()


def _texts(rng, n, lo, hi):
    words = np.asarray(WORDS)
    return [" ".join(words[rng.integers(0, len(words), rng.integers(lo, hi))])
            for _ in range(n)]


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(
        JaxConfig(**SMALL), tokenizer=JaxHashTokenizer(SMALL["vocab_size"]),
        max_seq_len=48, seed=7,
    )
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(SMALL["vocab_size"]), max_seq_len=48,
        device="cpu",
    )
    return jenc, tenc


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31)
    chunks = [{"id": f"c{i}", "text": t, "chunk_type": "word_based"}
              for i, t in enumerate(_texts(rng, 90, 4, 24))]
    chunks[50]["text"] = chunks[7]["text"]  # a duplicate: exact ties
    queries = _texts(rng, 10, 1, 5) + [chunks[7]["text"], "نامعلوم کاملا"]
    return chunks, queries


def _systems(encoders, chunks, method="hybrid", **kw):
    jenc, tenc = encoders
    j = JaxRetrieval(method=method, encoder=jenc, **kw)
    t = RetrievalSystem(method=method, encoder=tenc, **kw)
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)
    return j, t


@pytest.fixture(scope="module")
def hybrid(encoders, corpus):
    return _systems(encoders, corpus[0])


def assert_rows_match(got, want, rtol=1e-5):
    """Scores within rtol; ids equal wherever neighbouring scores are more
    than 1e-5 apart or tie exactly."""
    assert len(got) == len(want)
    n_clear = n_all = 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gs = np.array([s for _, s in g])
        ws = np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-6)
        gap = np.abs(np.diff(ws))
        ok = (gap > 1e-5) | (gap == 0)
        clear = np.ones(len(w), bool)
        clear[1:] &= ok
        clear[:-1] &= ok
        gi = np.array([c["id"] for c, _ in g])
        wi = np.array([c["id"] for c, _ in w])
        np.testing.assert_array_equal(gi[clear], wi[clear])
        n_clear += clear.sum()
        n_all += len(w)
    assert n_clear >= 0.7 * n_all


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_hybrid_matches_jax(hybrid, corpus, fused, rerank):
    j, t = hybrid
    queries = corpus[1]
    assert t._hybrid_fused_supported()
    want = j.retrieve_hybrid_batch(queries, top_k=6, rerank=rerank,
                                   fused=fused)
    got = t.retrieve_hybrid_batch(queries, top_k=6, rerank=rerank,
                                  fused=fused)
    assert_rows_match(got, want, rtol=1e-4 if rerank else 1e-5)
    # the duplicate chunks tie exactly: lower id first in both
    ids = [c["id"] for c, _ in got[-2]]
    if not rerank and "c7" in ids and "c50" in ids:
        assert ids.index("c7") < ids.index("c50")


def test_device_chain_matches_host_loop(hybrid, corpus):
    _, t = hybrid
    for rerank in (False, True):
        dev = t.retrieve_hybrid_batch(corpus[1], top_k=5, rerank=rerank,
                                      fused=True)
        host = t.retrieve_hybrid_batch(corpus[1], top_k=5, rerank=rerank,
                                       fused=False)
        assert_rows_match(dev, host)


def test_hybrid_nondefault_weights_and_k_beyond_corpus(hybrid, corpus):
    j, t = hybrid
    q = corpus[1][:3]
    assert_rows_match(
        t.retrieve_hybrid_batch(q, 4, dense_weight=0.3, bm25_weight=0.7),
        j.retrieve_hybrid_batch(q, 4, dense_weight=0.3, bm25_weight=0.7),
    )
    got = t.retrieve_hybrid_batch(q[:1], top_k=500)
    want = j.retrieve_hybrid_batch(q[:1], top_k=500)
    assert len(got[0]) == len(want[0]) <= len(corpus[0])
    assert {c["id"] for c, _ in got[0]} == {c["id"] for c, _ in want[0]}
    assert_rows_match(got, want)


def test_hybrid_cosine_metric(encoders, corpus):
    j, t = _systems(encoders, corpus[0], dense_metric="cosine")
    for rerank in (False, True):
        assert_rows_match(
            t.retrieve_hybrid_batch(corpus[1], 5, rerank=rerank),
            j.retrieve_hybrid_batch(corpus[1], 5, rerank=rerank),
            rtol=1e-4,
        )


def test_hybrid_union_kernel_matches_jax(encoders, corpus, monkeypatch):
    """The union gate forced open in both packages (and the union-hash
    copy built): the lexical channel goes through the batch-dedup
    kernels."""
    for mod in (jlex, tlex):
        monkeypatch.setattr(mod, "_UNION_MIN_SLOTS", 1)
        monkeypatch.setattr(mod, "_UNION_MAX_FRAC", 1.0)
        monkeypatch.setattr(mod, "_UNION_HASH_MIN_N", 1)
        monkeypatch.setattr(mod, "_UNION_HASH_MIN_L", 1)
    j, t = _systems(encoders, corpus[0])
    bm = t.bm25_index
    qids, _ = bm._encode_queries([bm._query_terms(q) for q in corpus[1]])
    assert bm._union_gate(qids)
    assert_rows_match(t.retrieve_hybrid_batch(corpus[1], 4),
                      j.retrieve_hybrid_batch(corpus[1], 4))


def test_rerank_gate_respects_provenance(encoders, corpus):
    """Foreign embeddings + rerank take the host loop (the device rerank
    gathers stored rows, which are not this encoder's)."""
    _, tenc = encoders
    chunks = corpus[0]
    foreign = np.random.default_rng(3).standard_normal(
        (len(chunks), SMALL["hidden_size"])).astype(np.float32)
    t = RetrievalSystem(method="hybrid", encoder=tenc)
    assert t.load_chunks_and_index(chunks, embeddings=foreign,
                                   embeddings_from_encoder=False)
    assert t.retrieve_hybrid_batch(corpus[1][:1], top_k=3)[0]
    called = {"n": 0}
    orig = t._retrieve_hybrid_fused

    def spy(*a, **k):
        called["n"] += 1
        return orig(*a, **k)

    t._retrieve_hybrid_fused = spy
    t.retrieve_hybrid_batch(corpus[1][:1], top_k=3, rerank=True)
    assert called["n"] == 0
    t.retrieve_hybrid_batch(corpus[1][:1], top_k=3)
    assert called["n"] == 1


@pytest.mark.parametrize("method", ["bm25", "tfidf"])
def test_lexical_methods_match_jax(encoders, corpus, method):
    chunks, queries = corpus
    j = JaxRetrieval(method=method)
    t = RetrievalSystem(method=method, device="cpu")
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)
    assert t.dense_index is None
    assert (t.bm25_index is None) == (method == "tfidf")
    assert (t.tfidf_index is None) == (method == "bm25")
    assert_rows_match(t.retrieve_batch(queries, 7), j.retrieve_batch(queries, 7))
    assert_rows_match([t.retrieve(queries[0], 3)], [j.retrieve(queries[0], 3)])
    for budget in (2000, 150):
        got_c, got_m = t.get_contexts_for_rag(queries[2], 5, budget)
        want_c, want_m = j.get_contexts_for_rag(queries[2], 5, budget)
        assert got_c == want_c
        np.testing.assert_allclose([m["score"] for m in got_m],
                                   [m["score"] for m in want_m], rtol=1e-5)
    tests = [{"id": f"q{i}", "question": q} for i, q in enumerate(queries)]
    ranked = j.retrieve_batch(queries, 10)
    relevant = {f"q{i}": [ranked[i][i % 3][0]["id"]] if ranked[i] else ["x"]
                for i in range(len(queries))}
    assert t.evaluate_retrieval_quality(tests, relevant, batch_size=4) == \
        pytest.approx(j.evaluate_retrieval_quality(tests, relevant,
                                                   batch_size=4))


@pytest.mark.parametrize("method", ["dense", "bm25", "tfidf", "hybrid"])
def test_retrieve_batch_raises_after_cleanup(encoders, corpus, method):
    """cleanup() leaves neither package's system ready: retrieve_batch
    raises instead of answering empty lists."""
    chunks, queries = corpus
    systems = _systems(encoders, chunks, method=method)
    for system in systems:
        assert system.retrieve_batch(queries[:2], 3)[0]
        system.cleanup()
        assert not system.is_ready
        with pytest.raises(RuntimeError, match="not ready"):
            system.retrieve_batch(queries[:2], 3)


# -- the fusion ops --------------------------------------------------------------


def test_fuse_hybrid_dedup_keeps_dense_occurrence():
    """An id in both channels gets one fused entry with both parts."""
    s, i = thf.fuse_hybrid(
        torch.tensor([[1.0, 4.0]]), torch.tensor([[7, 3]]),
        torch.tensor([[2.0, 1.0]]), torch.tensor([[3, 9]]), k=4,
        dense_sim="l2",
    )
    got = {int(ii): float(ss) for ss, ii in zip(s[0], i[0]) if ii >= 0}
    want = {3: 0.64, 7: 0.6, 9: 0.2}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert int(i[0, 3]) == -1 and float(s[0, 3]) == np.float32(thf.NEG_INF)


@pytest.mark.parametrize("dense_sim", ["l2", "sim"])
def test_fuse_hybrid_equals_jax(dense_sim):
    """Random channels with shared ids, invalid slots, exact fused ties
    and all-zero BM25 rows."""
    rng = np.random.default_rng(9)
    q, m_d, m_b = 6, 8, 8
    d_s = np.sort(rng.random((q, m_d)).astype(np.float32) * 4, axis=1)
    if dense_sim == "sim":
        d_s = d_s[:, ::-1].copy()
    d_i = np.stack([rng.choice(20, m_d, replace=False) for _ in range(q)])
    l_s = -np.sort(-rng.integers(0, 5, (q, m_b)).astype(np.float32), axis=1)
    l_s[2] = 0.0
    l_i = np.stack([rng.choice(20, m_b, replace=False) for _ in range(q)])
    d_i[1, -2:] = -1
    l_i[3, -3:] = -1
    args = (d_s, d_i.astype(np.int32), l_s, l_i.astype(np.int32))
    for w in ((0.6, 0.4), (0.5, 0.5)):
        ws, wi = jhf.fuse_hybrid(*map(jnp.asarray, args), k=10,
                                 dense_weight=w[0], bm25_weight=w[1],
                                 dense_sim=dense_sim)
        gs, gi = thf.fuse_hybrid(*map(torch.from_numpy, args), k=10,
                                 dense_weight=w[0], bm25_weight=w[1],
                                 dense_sim=dense_sim)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def test_rerank_cosine_equals_jax_and_masks_invalid():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    rows = rng.standard_normal((3, 5, 8)).astype(np.float32)
    rows[0, 3] = rows[0, 1]  # exact cosine tie keeps the fused order
    ids = np.array([[4, 1, 7, 2, -1], [0, 3, -1, -1, -1], [9, 8, 7, 6, 5]],
                   np.int32)
    fused = np.zeros((3, 5), np.float32)
    rows[ids < 0] = 0.0
    ws, wi = jhf.rerank_cosine(*map(jnp.asarray, (q, rows, fused, ids)))
    gs, gi = thf.rerank_cosine(*map(torch.from_numpy, (q, rows, fused, ids)))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-6)
    assert list(gi[1, 2:]) == [-1, -1, -1]
    got = thf.gather_rows_device(torch.tensor([[1, -1]]),
                                 torch.arange(12.0).view(4, 3))
    np.testing.assert_array_equal(got.numpy(), [[[3, 4, 5], [0, 0, 0]]])


# -- serving -------------------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _as_rows(hits):
    return [({"id": h["id"]}, h["score"]) for h in hits]


@pytest.mark.parametrize("method", ["bm25", "hybrid"])
def test_server_matches_jax_server(encoders, corpus, method):
    """/health, /search and /rag answer as the JAX server's. Each request
    goes alone to both servers, in one order; then the three go to the
    port's server at once, and each concurrent answer must equal the JAX
    server's answer to that request alone. (The port serves a hybrid
    micro-batch one call per top_k. The JAX server serves a micro-batch at
    its largest top_k, and a hybrid list over-retrieves at 2 k, so its
    answer to a concurrent request depends on what it was batched with.)"""
    chunks, queries = corpus
    j, t = _systems(encoders, chunks, method=method)
    requests = [
        {"queries": queries[:2], "top_k": 3},
        {"queries": queries[2:5], "top_k": 5},
        {"query": queries[5], "top_k": 4},
    ]
    answers = {}
    for name, system, server_cls in (("jax", j, JaxServer),
                                     ("torch", t, RetrievalServer)):
        with server_cls(system, max_wait_ms=20.0) as server:
            health = _get(server.url + "/health")
            assert health["status"] == "ok" and health["method"] == method
            alone = [_post(server.url + "/search", r) for r in requests]
            together = [None] * len(requests)

            def call(i, url=server.url):
                together[i] = _post(url + "/search", requests[i])

            if name == "torch":
                threads = [threading.Thread(target=call, args=(i,))
                           for i in range(len(requests))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                    assert not th.is_alive()
            rag = _post(server.url + "/rag",
                        {"question": queries[0], "top_k": 3})
        answers[name] = (alone, together, rag)
    (j_alone, _, j_rag), (t_alone, t_together, t_rag) = (answers["jax"],
                                                         answers["torch"])
    for got_alone, got_together, want in zip(t_alone, t_together, j_alone):
        for got in (got_alone, got_together):
            assert_rows_match([_as_rows(r) for r in got["results"]],
                              [_as_rows(r) for r in want["results"]])
    assert t_rag["contexts"] == j_rag["contexts"]
    assert t_rag["answer"] is None


def test_server_serves_a_hybrid_micro_batch_per_top_k(encoders, corpus):
    """A hybrid micro-batch at top_k 3, 5 and 3 is served in two calls (3,
    then 5), each request its rows alone; a BM25 one at one depth in a
    single call at its largest top_k."""
    from persian_rag_tpu_torch.serve.api import _Pending

    chunks, queries = corpus
    _, t = _systems(encoders, chunks, method="hybrid")
    assert [t.top_k_depth(k) for k in (3, 5)] == [3, 5]
    calls = []
    orig = t.retrieve_batch

    def spy(qs, top_k=10):
        calls.append((list(qs), top_k))
        return orig(qs, top_k)

    t.retrieve_batch = spy
    server = RetrievalServer(t)
    try:
        group = [_Pending(queries[:2], 3), _Pending(queries[2:5], 5),
                 _Pending(queries[5:6], 3)]
        server._serve_group(group)
    finally:
        server._server.server_close()
    assert calls == [(queries[:2] + queries[5:6], 3), (queries[2:5], 5)]
    assert server.batches_served == 2
    for pending in group:
        want = orig(pending.queries, pending.top_k)
        got = [[({"id": h["id"]}, h["score"]) for h in r]
               for r in pending.results]
        assert_rows_match(got, [[({"id": c["id"]}, s) for c, s in r]
                                for r in want])
    _, b = _systems(encoders, chunks, method="bm25")
    assert {b.top_k_depth(k) for k in (3, 5, 200)} == {0}
    # an int8 tier re-ranks max(10 k, 100) candidates with a refine copy
    from persian_rag_tpu_torch.index.dense import DenseIndex

    d = RetrievalSystem(method="dense", device="cpu")
    d.dense_index = DenseIndex(8, metric="ip", storage_dtype=torch.int8,
                               device="cpu")
    assert [d.top_k_depth(k) for k in (5, 10, 20)] == [100, 100, 200]
    d.dense_index = DenseIndex(8, metric="ip", storage_dtype=torch.int8,
                               refine_dtype=None, device="cpu")
    assert d.top_k_depth(20) == 0
