"""The port's RAGEvaluator and MultiModelRetrieval against the JAX
package's.

* `evaluate_single_rag` over BM25 and TF-IDF retrievers built on the same
  seeded chunks, each package against its own extractive
  `FakeLlamaServer`: every key that does not measure time is equal.
* Dense and hybrid on a tiny encoder whose Flax parameters are carried
  into the port: the retrieved ids equal the JAX package's, near-ties
  aside, and on the questions whose lists are equal the metrics are equal
  (the semantic ones within 1e-5).
* `_analyze_model_comparison`, the markdown report and the saved JSON
  (numpy values included) are equal.
* The corrected fault: a retrieval that raises propagates in the port,
  where the JAX package scores the batch as failed retrievals.
* `MultiModelRetrieval.compare_retrieval_performance` is equal.
"""
import json
import re

import jax
import numpy as np
import pytest

from persian_rag_tpu.data.loader import synthetic_persian_qa
from persian_rag_tpu.eval.evaluator import RAGEvaluator as JaxEvaluator
from persian_rag_tpu.gen.client import LlamaClient as JaxClient
from persian_rag_tpu.gen.fake_server import FakeLlamaServer as JaxFake
from persian_rag_tpu.models.encoder import EncoderConfig as JaxEncConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.retrieval.system import (
    MultiModelRetrieval as JaxMulti,
    RetrievalSystem as JaxRS,
)

from persian_rag_tpu_torch.eval import evaluator as tev
from persian_rag_tpu_torch.eval.evaluator import RAGEvaluator
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.retrieval.system import (
    MultiModelRetrieval,
    RetrievalSystem,
)

SMALL = dict(vocab_size=3000, hidden_size=48, num_layers=2, num_heads=4,
             intermediate_size=96, max_position_embeddings=64)
ITEMS = synthetic_persian_qa(24, seed=17)


def _chunks():
    """Every other context of ITEMS whole, the rest cut at their
    sentences, plus seeded noise."""
    rng = np.random.default_rng(3)
    out = []
    for i, item in enumerate(ITEMS):
        if i % 2:
            out += re.split(r"(?<=\.) ", item["context"])
        else:
            out.append(item["context"])
    words = " ".join(out).split()
    for _ in range(30):
        out.append(" ".join(rng.choice(words, int(rng.integers(4, 16)))))
    order = rng.permutation(len(out))
    return [{"id": f"chunk_{i}", "text": out[j], "chunk_type": "sentence"}
            for i, j in enumerate(order)]


CHUNKS = _chunks()


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(JaxEncConfig(**SMALL), max_seq_len=48, seed=6)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        max_seq_len=48, device="cpu",
    )
    return jenc, tenc


@pytest.fixture(scope="module")
def servers():
    with JaxFake() as jurl, FakeLlamaServer() as turl:
        yield jurl, turl


def _untimed(results):
    return {k: v for k, v in results.items() if "time" not in k}


def _systems(method, encoders):
    jenc, tenc = encoders
    dense = method in ("dense", "hybrid")
    js = JaxRS(method=method, encoder=jenc if dense else None)
    ts = RetrievalSystem(method=method, encoder=tenc if dense else None,
                         device="cpu")
    assert js.load_chunks_and_index(CHUNKS)
    assert ts.load_chunks_and_index(CHUNKS)
    return js, ts


@pytest.mark.parametrize("method", ["bm25", "tfidf"])
def test_lexical_evaluation_equal(method, servers, encoders):
    jurl, turl = servers
    js, ts = _systems(method, encoders)
    want = JaxEvaluator(llama_client=JaxClient(jurl)).evaluate_single_rag(
        js, ITEMS, model_name=method, retrieval_batch_size=7)
    got = RAGEvaluator(llama_client=LlamaClient(turl)).evaluate_single_rag(
        ts, ITEMS, model_name=method, retrieval_batch_size=7)
    assert list(got) == list(want)  # the same keys in the same order
    assert _untimed(got) == _untimed(want)
    assert got[f"{method}_num_samples"] == len(ITEMS)
    assert got[f"{method}_failed_retrievals"] == 0
    assert 0 < got[f"{method}_f1_score"] < 1
    assert 0 < got[f"{method}_context_recall"]
    # a sample and a top_k of their own
    want = JaxEvaluator(llama_client=JaxClient(jurl)).evaluate_single_rag(
        js, ITEMS, model_name="m", sample_size=9, top_k=2)
    got = RAGEvaluator(llama_client=LlamaClient(turl)).evaluate_single_rag(
        ts, ITEMS, model_name="m", sample_size=9, top_k=2)
    assert _untimed(got) == _untimed(want) and got["m_num_samples"] == 9


def _ids(rows):
    return [[c["id"] for c, _ in row] for row in rows]


@pytest.mark.parametrize("method", ["dense", "hybrid"])
def test_dense_evaluation_equal_where_lists_are(method, servers, encoders):
    jurl, turl = servers
    js, ts = _systems(method, encoders)
    questions = [item["question"] for item in ITEMS]
    jrows = js.retrieve_batch(questions, 5)
    trows = ts.retrieve_batch(questions, 5)
    same = []
    for i, (jr, tr) in enumerate(zip(jrows, trows)):
        if _ids([jr]) == _ids([tr]):
            same.append(i)
            continue
        # a near-tie: the two lists' scores agree position by position
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr],
                                   rtol=0, atol=1e-5)
    assert len(same) >= len(ITEMS) - 2
    items = [ITEMS[i] for i in same]
    want = JaxEvaluator(llama_client=JaxClient(jurl)).evaluate_single_rag(
        js, items, model_name=method)
    got = RAGEvaluator(llama_client=LlamaClient(turl)).evaluate_single_rag(
        ts, items, model_name=method)
    assert list(got) == list(want)
    semantic = (f"{method}_semantic_similarity", f"{method}_answer_relevancy")
    for key in semantic:
        assert abs(got[key] - want[key]) <= 1e-5, key
    strip = lambda r: {k: v for k, v in _untimed(r).items()
                       if k not in semantic}
    assert strip(got) == strip(want)


def _performances():
    """Per-model results as evaluate_single_rag writes them, numpy values
    among them, with ties and a missing metric."""
    rng = np.random.default_rng(8)
    perfs = {}
    for name in ("bm25", "tfidf", "dense", "hybrid"):
        res = {f"{name}_{m}": float(rng.random()) for m in
               tev.COMPARISON_METRICS}
        res[f"{name}_f1_score"] = 0.5  # a tie across models
        res[f"{name}_num_samples"] = np.int64(10)
        res[f"{name}_bleu_score"] = np.float32(rng.random())
        perfs[name] = res
    del perfs["tfidf"]["tfidf_semantic_similarity"]
    return perfs


def test_comparison_report_and_json_equal(tmp_path):
    perfs = _performances()
    jev = JaxEvaluator(llama_client=JaxClient("http://127.0.0.1:9"))
    tev_ = RAGEvaluator(llama_client=LlamaClient("http://127.0.0.1:9"))
    want = jev._analyze_model_comparison(perfs)
    got = tev_._analyze_model_comparison(perfs)
    assert got == want
    assert json.dumps(tev._to_jsonable(got)) == json.dumps(
        tev._to_jsonable(want))
    assert got["ranking"]["total_time"][0]["score"] == min(
        p[f"{n}_total_time"] for n, p in perfs.items())
    assert tev_._analyze_model_comparison({}) == {} == \
        jev._analyze_model_comparison({})
    results = {
        "evaluation_metadata": {
            "timestamp": "2026-01-01T00:00:00", "models_evaluated": list(perfs),
            "num_test_questions": 10, "chunk_types": ["word", "sentence"],
            "enhancement": "e", "llm_connectivity": "connected"},
        "word_chunks_comparison": got,
        "sentence_chunks_comparison": tev_._analyze_model_comparison(
            {k: perfs[k] for k in ("bm25", "dense")}),
        "word_bm25_results": perfs["bm25"],
        "array": np.arange(3, dtype=np.float32), "tuple": (np.int32(1), 2.5),
    }
    assert tev_.create_evaluation_report(results) == \
        jev.create_evaluation_report(results)
    assert tev_.create_evaluation_report({}) == jev.create_evaluation_report({})
    jpath = jev.save_evaluation_results(results, "r.json", str(tmp_path / "j"))
    tpath = tev_.save_evaluation_results(results, "r.json", str(tmp_path / "t"))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


class _Raising:
    """A retriever whose batch retrieval fails, as a failed launch would."""
    embedding_model = None

    def retrieve_batch(self, queries, top_k):
        raise RuntimeError("kernel launch failed")


class _Empty:
    embedding_model = None

    def retrieve_batch(self, queries, top_k):
        return [[] for _ in queries]


def test_retrieval_error_propagates(servers):
    """The JAX package scores a raising retrieval as failed retrievals and
    goes on; the port lets the exception out. An empty list still counts
    as a failed retrieval in both."""
    jurl, turl = servers
    jev = JaxEvaluator(llama_client=JaxClient(jurl))
    tev_ = RAGEvaluator(llama_client=LlamaClient(turl))
    want = jev.evaluate_single_rag(_Raising(), ITEMS[:5], model_name="m")
    assert want["m_failed_retrievals"] == 5 and want["m_success_rate"] == 0.0
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tev_.evaluate_single_rag(_Raising(), ITEMS[:5], model_name="m")
    want = jev.evaluate_single_rag(_Empty(), ITEMS[:5], model_name="m")
    got = tev_.evaluate_single_rag(_Empty(), ITEMS[:5], model_name="m")
    assert _untimed(got) == _untimed(want)
    assert got["m_failed_retrievals"] == 5


def test_failed_generations_counted_as_jax(encoders):
    """An unreachable LLM server: every answer is None, counted in
    failed_generations as the JAX package counts it."""
    js, ts = _systems("bm25", encoders)
    dead = "http://127.0.0.1:9"
    want = JaxEvaluator(llama_client=JaxClient(dead)).evaluate_single_rag(
        js, ITEMS[:6], model_name="m")
    got = RAGEvaluator(llama_client=LlamaClient(dead)).evaluate_single_rag(
        ts, ITEMS[:6], model_name="m")
    assert _untimed(got) == _untimed(want)
    assert got["m_failed_generations"] == 6


def test_multi_model_retrieval_equal(encoders):
    jenc, tenc = encoders
    jm = JaxMulti({"tiny": jenc})
    tm = MultiModelRetrieval({"tiny": tenc})
    jm.setup_retrievers(CHUNKS)
    tm.setup_retrievers(CHUNKS)
    assert list(tm.retrievers) == ["tiny"]
    assert tm.retrievers["tiny"].device.type == "cpu"
    queries = [{"id": f"q{i}", "question": item["question"]}
               for i, item in enumerate(ITEMS)]
    # relevant: the chunks holding the item's answer sentence
    relevant = {f"q{i}": [c["id"] for c in CHUNKS
                          if item["answer"] in c["text"]]
                for i, item in enumerate(ITEMS)}
    relevant["q0"] = []
    want = jm.compare_retrieval_performance(queries, relevant)
    got = tm.compare_retrieval_performance(queries, relevant)
    assert got == want
    assert got["tiny"]["total_queries"] == len(ITEMS)
    tm.cleanup_all()
    jm.cleanup_all()
    assert tm.retrievers == {}
