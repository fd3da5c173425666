"""The port's IVF retrieval front end against the JAX package's.

`RetrievalSystem(dense_index_type="ivf")` in both packages over the same
corpus vectors (the JAX encoder's, rounded to multiples of 1/64 so that
both packages train on the same f32 values), the port's k-means started
from JAX's initial rows (a monkeypatched `_init_rows`: the draw itself is
a chosen divergence), and the queries through each package's encoder on
the same converted weights: the cells must be equal, and the ids equal
through `retrieve`, `retrieve_batch` and `RetrievalServer`'s /search. An
IVF FAISS file written by JAX serves in both. The fixture asserts that the
probed centroids and the top ranks stand more than 1e-4 apart, so that the
id checks mean something. A hybrid IVF system fuses on the host and
reranks on `IVFIndex.rows`, as the JAX package's does.
"""
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

from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.index import ivf as tivf
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
from persian_rag_tpu_torch.serve.api import RetrievalServer

SMALL = dict(vocab_size=2000, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=64)
WORDS = ("دارو درمان بیماری پزشک قلب خون فشار دیابت کودک مادر تغذیه ورزش "
         "خواب درد معده کبد کلیه عفونت قرص آزمایش تشخیص پیشگیری پوست چشم "
         "دندان استخوان تب سرفه ویتامین آهن چاقی اضطراب حافظه بارداری "
         "قانون تاریخ دانشگاه شعر حافظ شهر خانه اقتصاد").split()
N_CHUNKS, CELLS, NPROBE, TOP_K = 120, 8, 2, 5


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
def corpus(encoders):
    jenc, _ = encoders
    rng = np.random.default_rng(9)  # a seed whose gaps all exceed 1e-4
    chunks = [
        {"id": f"c{i}", "text": t, "chunk_type": "paragraph"}
        for i, t in enumerate(_texts(rng, N_CHUNKS, 6, 30, "بخش"))
    ]
    queries = _texts(rng, 6, 3, 8, "پرسش")
    emb = np.round(jenc.encode([c["text"] for c in chunks]) * 64) / 64
    return chunks, queries, emb.astype(np.float32)


@pytest.fixture
def jax_init_rows(monkeypatch):
    """The port's k-means starts from the rows jax.random.choice draws."""
    def init(n, n_cells, seed):
        rows = jax.random.choice(jax.random.PRNGKey(seed), n, (n_cells,),
                                 replace=False)
        return torch.from_numpy(np.array(rows))

    monkeypatch.setattr(tivf, "_init_rows", init)


def _ids(rows):
    return [[c["id"] for c, _ in row] for row in rows]


def _scores(rows):
    return np.array([[s for _, s in row] for row in rows])


def _assert_separated(index, jenc, queries, metric):
    """The probe's nprobe-th and next centroid, and the top TOP_K + 1
    scores, stand more than 1e-4 apart for every query."""
    q = jenc.encode(queries)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    cent = np.asarray(index.centroids)
    d2 = ((q[:, None, :] - cent[None]) ** 2).sum(-1)
    d2.sort(axis=1)
    assert (d2[:, NPROBE] - d2[:, NPROBE - 1]).min() > 1e-4
    raw, _ = index.search(jenc.encode(queries), TOP_K + 1)
    gaps = np.abs(np.diff(np.asarray(raw), axis=1))
    assert gaps.min() > 1e-4, gaps.min()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_ivf_system_matches_jax(encoders, corpus, jax_init_rows, metric):
    jenc, tenc = encoders
    chunks, queries, emb = corpus
    kw = dict(method="dense", dense_metric=metric, dense_index_type="ivf",
              ivf_cells=CELLS, ivf_nprobe=NPROBE)
    j = JaxRetrieval(encoder=jenc, **kw)
    t = RetrievalSystem(encoder=tenc, **kw)
    assert j.load_chunks_and_index(chunks, embeddings=emb)
    assert t.load_chunks_and_index(chunks, embeddings=emb)
    assert isinstance(t.dense_index, tivf.IVFIndex)
    assert t.dense_index.n_cells == CELLS and t.dense_index.nprobe == NPROBE
    np.testing.assert_array_equal(t.dense_index._cell_ids.numpy(),
                                  np.asarray(j.dense_index._cell_ids))
    _assert_separated(j.dense_index, jenc, queries, metric)
    want = j.retrieve_batch(queries, top_k=TOP_K)
    got = t.retrieve_batch(queries, top_k=TOP_K)
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-5,
                               atol=1e-6)
    assert [c["id"] for c, _ in t.retrieve(queries[0], top_k=3)] == \
        _ids(want)[0][:3]
    assert t.top_k_depth(TOP_K) == 0


def _served(system, server_cls, requests):
    out = [None] * len(requests)
    with server_cls(system, max_wait_ms=20.0) as server:
        def call(i, url=server.url):
            req = urllib.request.Request(
                url + "/search", data=json.dumps(requests[i]).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out[i] = json.loads(resp.read())

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    return [[[h["id"] for h in r] for r in o["results"]] for o in out]


def test_ivf_faiss_file_served_by_both(encoders, corpus, tmp_path):
    """JAX builds and exports an IVF FAISS file; both systems serve it
    (the port's refusal of IVF files is gone) and answer alike."""
    jenc, tenc = encoders
    chunks, queries, emb = corpus
    build = JaxRetrieval(method="dense", encoder=jenc, dense_index_type="ivf",
                         ivf_cells=CELLS, ivf_nprobe=NPROBE)
    assert build.load_chunks_and_index(chunks, embeddings=emb)
    path = str(tmp_path / "chunks.index")
    build.dense_index.export_faiss(path)
    j = JaxRetrieval(method="dense", encoder=jenc)
    t = RetrievalSystem(method="dense", encoder=tenc, dense_metric="ip",
                        device="cpu")
    assert j.load_chunks_and_index(chunks, faiss_index_file=path)
    assert t.load_chunks_and_index(chunks, faiss_index_file=path)
    assert isinstance(t.dense_index, tivf.IVFIndex)
    assert t.dense_metric == "l2" and t._rows_match_encoder is False
    assert t.dense_index.nprobe == NPROBE  # the file's nprobe
    _assert_separated(j.dense_index, jenc, queries, "l2")
    assert _ids(t.retrieve_batch(queries, TOP_K)) == _ids(
        j.retrieve_batch(queries, TOP_K))
    requests = [
        {"queries": queries[:2], "top_k": 3},
        {"queries": queries[2:5], "top_k": 5},
        {"query": queries[5], "top_k": 4},
    ]
    assert _served(t, RetrievalServer, requests) == _served(
        j, JaxServer, requests)


def test_hybrid_over_ivf_reranks_on_its_rows(encoders, corpus,
                                             jax_init_rows):
    jenc, tenc = encoders
    chunks, queries, emb = corpus
    kw = dict(method="hybrid", dense_index_type="ivf", ivf_cells=CELLS,
              ivf_nprobe=NPROBE)
    j = JaxRetrieval(encoder=jenc, **kw)
    t = RetrievalSystem(encoder=tenc, **kw)
    assert j.load_chunks_and_index(chunks, embeddings=emb)
    assert t.load_chunks_and_index(chunks, embeddings=emb)
    assert not t._hybrid_fused_supported()  # the device chain is flat-only
    calls = []
    rows = t.dense_index.rows
    t.dense_index.rows = lambda ids: calls.append(len(ids)) or rows(ids)
    for rerank in (False, True):
        want = j.retrieve_hybrid_batch(queries, top_k=TOP_K, rerank=rerank)
        got = t.retrieve_hybrid_batch(queries, top_k=TOP_K, rerank=rerank)
        assert _ids(got) == _ids(want)
        np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-4,
                                   atol=1e-5)
    assert calls == [len(queries) * TOP_K]  # the rerank read stored rows


def test_mesh_still_raises_p7(encoders):
    """The mesh is ported: a non-Mesh raises TypeError, and an IVF system
    on a 4-shard mesh serves the exact-probe lists of a single-device one
    when every cell is probed."""
    _, tenc = encoders
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalSystem(encoder=tenc, dense_index_type="ivf", mesh=object())
    chunks = [{"id": f"c{i}", "text": f"متن {i} دارو"} for i in range(60)]
    vecs = np.random.default_rng(0).standard_normal((60, 8)).astype(
        np.float32)
    systems = [RetrievalSystem(encoder=tenc, dense_index_type="ivf",
                               ivf_cells=5, ivf_nprobe=5, **kw)
               for kw in (dict(device="cpu"),
                          dict(mesh=build_mesh(4, 1, devices=["cpu"] * 4)))]
    for s in systems:
        s.load_chunks_and_index(chunks, embeddings=vecs,
                                embeddings_from_encoder=False)
    got, want = (s.dense_index.search(vecs[:5], 4) for s in systems[::-1])
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    with pytest.raises(ValueError, match="dense_index_type"):
        RetrievalSystem(encoder=tenc, dense_index_type="hnsw")
