"""The port's dense retrieval slice as a whole against the JAX package's.

The same (converted) encoder weights, chunks and queries go through the
JAX RetrievalSystem and the port's: ids must be identical, similarities,
RAG contexts and Hit@K / MRR must match. The fixture asserts that its
top-k score gaps exceed 1e-4, so that the id check means something. The
servers of both packages answer the same requests.
"""
import importlib
import json
import threading
import urllib.request

import jax
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

tft = importlib.import_module("persian_rag_tpu_torch.ops.flat_topk")

SMALL = dict(vocab_size=2000, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)
WORDS = ("دارو درمان بیماری پزشک قلب خون فشار دیابت کودک مادر تغذیه ورزش "
         "خواب درد معده کبد کلیه عفونت قرص آزمایش تشخیص پیشگیری پوست چشم "
         "دندان استخوان تب سرفه ویتامین آهن چاقی اضطراب حافظه بارداری "
         "قانون تاریخ دانشگاه شعر حافظ شهر خانه اقتصاد").split()


def _texts(rng, n, lo, hi, tag):
    words = np.asarray(WORDS)
    return [
        f"{tag} {i} " + " ".join(words[rng.integers(0, len(words),
                                                    rng.integers(lo, hi))])
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(
        JaxConfig(**SMALL), tokenizer=JaxHashTokenizer(SMALL["vocab_size"]),
        max_seq_len=32, seed=11,
    )
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(SMALL["vocab_size"]), max_seq_len=32,
        device="cpu",
    )
    return jenc, tenc


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(2051)  # a seed whose top-7 gaps all exceed 1e-4
    chunks = [
        {"id": f"c{i}", "text": t, "chunk_type": "paragraph"}
        for i, t in enumerate(_texts(rng, 60, 6, 30, "بخش"))
    ]
    queries = _texts(rng, 6, 3, 8, "پرسش")
    return chunks, queries


def _ids(rows):
    return [[c["id"] for c, _ in row] for row in rows]


def _scores(rows):
    return np.array([[s for _, s in row] for row in rows])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_slice_matches_jax(encoders, corpus, metric):
    jenc, tenc = encoders
    chunks, queries = corpus
    j = JaxRetrieval(method="dense", encoder=jenc, dense_metric=metric)
    t = RetrievalSystem(method="dense", encoder=tenc, dense_metric=metric)
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)

    want = j.retrieve_batch(queries, top_k=6)
    got = t.retrieve_batch(queries, top_k=6)
    # meaningful ids: in the index's own score space (squared L2 or
    # cosine) every adjacent pair of the top 6, and the 7th, is more
    # than 1e-4 apart
    raw, _ = j.dense_index.search(jenc.encode(queries), 7)
    gaps = np.abs(np.diff(np.asarray(raw), axis=1))
    assert gaps.min() > 1e-4, gaps.min()
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-5,
                               atol=1e-6)
    one = t.retrieve(queries[0], top_k=3)
    assert [c["id"] for c, _ in one] == _ids(want)[0][:3]
    assert [c["id"] for c, _ in t.retrieve_dense(queries[1], 2)] == \
        _ids(want)[1][:2]

    for budget in (2000, 150):
        got_c, got_m = t.get_contexts_for_rag(queries[2], 5, budget)
        want_c, want_m = j.get_contexts_for_rag(queries[2], 5, budget)
        assert got_c == want_c
        assert [m["chunk_id"] for m in got_m] == [
            m["chunk_id"] for m in want_m]
        np.testing.assert_allclose([m["score"] for m in got_m],
                                   [m["score"] for m in want_m], rtol=1e-5)

    tests = [{"id": f"q{i}", "question": q} for i, q in enumerate(queries)]
    relevant = {f"q{i}": [_ids(want)[i][i % 6]] for i in range(len(queries))}
    relevant["q5"] = ["nowhere"]
    got_eval = t.evaluate_retrieval_quality(tests, relevant, batch_size=4)
    want_eval = j.evaluate_retrieval_quality(tests, relevant, batch_size=4)
    assert got_eval == pytest.approx(want_eval)
    assert 0 < got_eval["mrr"] < 1


def test_two_stage_slice_matches_jax(encoders):
    """32,768 seeded unit-norm chunk embeddings: the port serves the
    two-stage regime (plain stage 1 on the CPU), the JAX package its
    materialized scan; queries go through both encoders."""
    jenc, tenc = encoders
    rng = np.random.default_rng(7)
    n = tft.TWO_STAGE_MIN_N
    emb = rng.standard_normal((n, SMALL["hidden_size"])).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    chunks = [{"id": i, "text": f"سند {i}"} for i in range(n)]
    queries = _texts(rng, 8, 3, 9, "پرسش")
    j = JaxRetrieval(method="dense", encoder=jenc, dense_metric="l2")
    t = RetrievalSystem(method="dense", encoder=tenc, dense_metric="l2")
    assert j.load_chunks_and_index(chunks, embeddings=emb)
    assert t.load_chunks_and_index(chunks, embeddings=emb)
    assert t.dense_index._stage1_mode != "scan"
    want = j.retrieve_batch(queries, top_k=10)
    got = t.retrieve_batch(queries, top_k=10)
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-5)
    assert t.dense_index._fail_streak == 0


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


def test_server_matches_jax_server(encoders, corpus):
    jenc, tenc = encoders
    chunks, queries = corpus
    j = JaxRetrieval(method="dense", encoder=jenc)
    t = RetrievalSystem(method="dense", encoder=tenc)
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)
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
            assert health["status"] == "ok" and health["method"] == "dense"
            out = [None] * len(requests)

            def call(i, url=server.url):
                out[i] = _post(url + "/search", requests[i])

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
                assert not th.is_alive()
            rag = _post(server.url + "/rag",
                        {"question": queries[0], "top_k": 3})
            assert _get(server.url + "/health")["requests_served"] == 3
        answers[name] = (out, rag)
    (j_out, j_rag), (t_out, t_rag) = answers["jax"], answers["torch"]
    for got, want in zip(t_out, j_out):
        assert [[h["id"] for h in r] for r in got["results"]] == [
            [h["id"] for h in r] for r in want["results"]]
        np.testing.assert_allclose(
            [[h["score"] for h in r] for r in got["results"]],
            [[h["score"] for h in r] for r in want["results"]], rtol=1e-5,
        )
    assert t_rag["contexts"] == j_rag["contexts"]
    assert t_rag["answer"] is None


def test_unported_methods_raise(encoders):
    _, tenc = encoders
    # IVF and a mesh are ported (tests/test_torch_retrieval_ivf.py,
    # test_torch_sharded_*.py): an object that is not a Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalSystem(encoder=tenc, mesh=object())
    # model_path loads a sentence-transformers directory (ported): a
    # missing one raises, and a given encoder wins over it
    with pytest.raises(FileNotFoundError):
        RetrievalSystem(model_path="/models/x", device="cpu")
    assert RetrievalSystem(encoder=tenc,
                           model_path="/models/x").embedding_model is tenc
    with pytest.raises(ValueError, match="unknown retrieval method"):
        RetrievalSystem(method="splade", encoder=tenc)
    # a CSV path is read (tests/test_torch_cli_serve.py); a missing one
    # raises
    with pytest.raises(FileNotFoundError):
        RetrievalSystem(encoder=tenc).load_chunks_and_index("chunks.csv")
    with pytest.raises(RuntimeError, match="not ready"):
        RetrievalSystem(encoder=tenc).retrieve("x")
    assert torch.get_default_dtype() == torch.float32
