"""parallel/sharded_search.py and DenseIndex(mesh=) of the port against
the JAX package's, on the CPU.

The same seeded numpy corpora go through the JAX sharded search on
conftest's 8 virtual CPU devices and through the port on a mesh of
repeated CPU devices; both are held to the port's single-device search.
Ids are equal and scores within 1e-4 (bf16 storage: 1e-2, the JAX test's
own limit for that tier).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.core.mesh import build_mesh as jbuild
from persian_rag_tpu.index.dense import DenseIndex as JaxDense
from persian_rag_tpu.parallel import sharded_search as jss
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.ops import flat_topk as ft
from persian_rag_tpu_torch.parallel import sharded_search as tss

TOL = dict(rtol=1e-4, atol=1e-4)


def _meshes(corpus, data=1):
    return (jbuild(corpus, data, devices=jax.devices()[:corpus * data]),
            build_mesh(corpus, data, devices=["cpu"] * (corpus * data)))


def _data(n, d, q, seed=0, dup=0, scale=1.0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        # rows i and i + n//2 are equal: ties across shards
        corpus[n // 2:n // 2 + dup] = corpus[:dup]
    queries = rng.standard_normal((q, d)).astype(np.float32)
    if dup:
        queries[:dup // 2] = corpus[:dup // 2] * scale
    return corpus, queries


def _check(got, want, tol=TOL):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), **tol)


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("n,shards", [(1000, 8), (1003, 8), (1003, 1),
                                      (5, 8)])
def test_sharded_flat_topk_equals_jax_and_single(metric, n, shards):
    corpus, queries = _data(n, 64, 9)
    k = min(10, n)
    jm, tm = _meshes(shards)
    jsh, jn = jss.shard_corpus(jnp.asarray(corpus), jm)
    want = jss.sharded_flat_topk(jnp.asarray(queries), jsh, k, jn, jm,
                                 metric=metric)
    tsh, tn = tss.shard_corpus(torch.from_numpy(corpus), tm)
    assert tn == n and len(tsh) == shards
    got = tss.sharded_flat_topk(torch.from_numpy(queries), tsh, k, tn, tm,
                                metric=metric)
    _check(got, want)
    single = ft.flat_topk_ref(torch.from_numpy(queries),
                              torch.from_numpy(corpus), k, metric)
    _check(got, single)


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_ties_across_shards_take_the_lower_id(metric):
    corpus, queries = _data(1000, 32, 24, seed=4, dup=40,
                            scale=10.0 if metric == "dot" else 1.0)
    jm, tm = _meshes(8)
    jsh, jn = jss.shard_corpus(jnp.asarray(corpus), jm)
    want = jss.sharded_flat_topk(jnp.asarray(queries), jsh, 6, jn, jm,
                                 metric=metric)
    tsh, tn = tss.shard_corpus(torch.from_numpy(corpus), tm)
    got = tss.sharded_flat_topk(torch.from_numpy(queries), tsh, 6, tn, tm,
                                metric=metric)
    _check(got, want)
    ids = got[1].numpy()
    # the duplicated queries' best two rows are a tie: the lower id first
    for q in range(20):
        assert ids[q, 0] == q and ids[q, 1] == q + 500, ids[q]


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_2d_route_with_caches_equals_jax(metric):
    """Queries split over data (9 rows over 2), corpus over 4 shards, with
    the serving caches threaded through both."""
    corpus, queries = _data(1003, 32, 9, seed=1)
    jm, tm = _meshes(4, 2)
    jsh, jn = jss.shard_corpus(jnp.asarray(corpus), jm)
    want = jss.sharded_flat_topk_2d(
        jnp.asarray(queries), jsh, 7, jn, jm, metric=metric,
        corpus_sqnorm_sharded=jnp.sum(jsh.astype(jnp.float32) ** 2, -1),
        corpus_bf16_sharded=jsh.astype(jnp.bfloat16))
    tsh, tn = tss.shard_corpus(torch.from_numpy(corpus), tm)
    sq = [[torch.sum(t * t, -1) for t in row] for row in tsh]
    got = tss.sharded_flat_topk_2d(torch.from_numpy(queries), tsh, 7, tn, tm,
                                   metric=metric, corpus_sqnorm_sharded=sq)
    _check(got, want)
    _check(got, ft.flat_topk_ref(torch.from_numpy(queries),
                                 torch.from_numpy(corpus), 7, metric))


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_dense_index_mesh_routes_equal_jax(metric):
    corpus, queries = _data(515, 24, 10, seed=2)
    jm, tm = _meshes(4, 2)
    single = DenseIndex(24, metric=metric, device="cpu")
    single.add(corpus)
    want = single.search(queries, 6)
    jidx = JaxDense(24, metric=metric, mesh=jm)
    jidx.add(corpus)
    idx = DenseIndex(24, metric=metric, mesh=tm)
    idx.add(corpus)
    idx.commit()
    assert idx.device == torch.device("cpu") and idx._shards is not None
    got = idx.search(queries, 6)
    _check(got, want)
    _check(got, jidx.search(queries, 6))
    # a batch smaller than the data axis takes the 1-D route
    _check(idx.search(queries[:1], 6), jidx.search(queries[:1], 6))
    _check(idx.search(queries[0], 6), jidx.search(queries[0], 6))


def test_dense_index_bf16_tier_on_mesh_equals_single():
    corpus, queries = _data(700, 32, 6, seed=3)
    jm, tm = _meshes(4, 2)
    single = DenseIndex(32, metric="ip", storage_dtype="bfloat16",
                        device="cpu")
    single.add(corpus)
    want = single.search(queries, 8)
    idx = DenseIndex(32, metric="ip", storage_dtype="bfloat16", mesh=tm)
    idx.add(corpus)
    got = idx.search(queries, 8)
    _check(got, want, dict(rtol=1e-4, atol=1e-4))
    jidx = JaxDense(32, metric="ip", storage_dtype=jnp.bfloat16, mesh=jm)
    jidx.add(corpus)
    _check(got, jidx.search(queries, 8), dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("shards,data", [(4, 2), (8, 1)])
def test_int8_tier_on_mesh_equals_jax(shards, data):
    corpus, queries = _data(700, 32, 6, seed=5)
    jm, tm = _meshes(shards, data)
    jidx = JaxDense(32, metric="ip", storage_dtype=jnp.int8, mesh=jm)
    jidx.add(corpus)
    idx = DenseIndex(32, metric="ip", storage_dtype="int8", mesh=tm)
    idx.add(corpus)
    got = idx.search(queries, 5)
    _check(got, jidx.search(queries, 5))
    # the refined int8 tier's ids are the exact ranking's here
    single = DenseIndex(32, metric="ip", device="cpu")
    single.add(corpus)
    np.testing.assert_array_equal(got[1].numpy(),
                                  single.search(queries, 5)[1].numpy())
    with pytest.raises(ValueError, match="refine copy"):
        DenseIndex(32, metric="ip", storage_dtype="int8", refine_dtype=None,
                   mesh=tm)
    with pytest.raises(ValueError, match="refine copy"):
        JaxDense(32, metric="ip", storage_dtype=jnp.int8, refine_dtype=None,
                 mesh=jm)


def test_fast_mode_on_mesh_keeps_the_sets():
    corpus, queries = _data(801, 32, 5, seed=6)
    _, tm = _meshes(4)
    tsh, tn = tss.shard_corpus(torch.from_numpy(corpus), tm)
    got = tss.sharded_flat_topk(torch.from_numpy(queries), tsh, 8, tn, tm,
                                metric="dot", mode="fast")
    want = ft.flat_topk_ref(torch.from_numpy(queries),
                            torch.from_numpy(corpus), 8, "dot")
    for q in range(5):
        assert set(got[1][q].tolist()) == set(want[1][q].tolist())


def test_each_shard_runs_the_two_stage_regime(monkeypatch):
    """Shards past TWO_STAGE_MIN_N rows run the two-stage regime (stage 1
    on the card), with the index's caches and center; the ids equal the
    f32 scan's."""
    calls = []
    real = ft.flat_topk_exact2_stream

    def counting(*args, **kw):
        calls.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(ft, "flat_topk_exact2_stream", counting)
    n = 2 * ft.TWO_STAGE_MIN_N + 6
    corpus, queries = _data(n, 16, 9, seed=7)
    _, tm = _meshes(2)
    idx = DenseIndex(16, metric="ip", mesh=tm, quality_floor=None)
    idx.add(corpus)
    got = idx.search(queries, 10)
    assert calls == [ft.TWO_STAGE_MIN_N + 3] * 2
    want = ft.flat_topk_scan(torch.from_numpy(queries),
                             torch.from_numpy(corpus), 10)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)


def test_retrieval_system_on_a_mesh_equals_single(tmp_path):
    """RetrievalSystem(mesh=): dense (built, and loaded from .npz and flat
    FAISS files onto the mesh), BM25 and hybrid (fused on the host, as the
    JAX package's mesh systems are), and MultiModelRetrieval."""
    from persian_rag_tpu_torch.models.encoder import EncoderConfig
    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.retrieval.system import (
        MultiModelRetrieval,
        RetrievalSystem,
    )

    cfg = EncoderConfig(vocab_size=256, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32,
                        max_position_embeddings=32)
    _, tm = _meshes(4, 2)
    encoders = [SentenceEncoder(cfg, seed=1, max_seq_len=16, **kw)
                for kw in (dict(device="cpu"), dict(mesh=tm))]
    rng = np.random.default_rng(8)
    words = [f"w{i}" for i in range(40)]
    chunks = [{"id": f"c{i}", "text": " ".join(rng.choice(words, 6))}
              for i in range(203)]
    queries = [" ".join(rng.choice(words, 3)) for _ in range(5)]

    def lists(results):
        return [[c["id"] for c, _ in r] for r in results]

    for method in ("dense", "bm25", "hybrid"):
        one = RetrievalSystem(method=method, encoder=encoders[0])
        sharded = RetrievalSystem(method=method, encoder=encoders[1],
                                  mesh=tm)
        assert sharded.mesh is tm and sharded.device == torch.device("cpu")
        for rs in (one, sharded):
            rs.load_chunks_and_index(chunks)
        assert not sharded._hybrid_fused_supported()
        assert lists(sharded.retrieve_batch(queries, 7)) == lists(
            one.retrieve_batch(queries, 7) if method != "hybrid" else
            one.retrieve_hybrid_batch(queries, 7, fused=False))
    path = str(tmp_path / "idx")
    one.dense_index.save(path)
    one.dense_index.export_faiss(path + ".index")
    for name in (path + ".npz", path + ".index"):
        rs = RetrievalSystem(method="dense", encoder=encoders[1], mesh=tm)
        rs.load_chunks_and_index(chunks, faiss_index_file=name)
        assert rs.dense_index.mesh is tm
        assert lists(rs.retrieve_batch(queries, 7)) == lists(
            one.retrieve_dense_batch(queries, 7))
    multi = MultiModelRetrieval({"m": encoders[1]}, mesh=tm)
    multi.setup_retrievers(chunks)
    assert multi.retrievers["m"].dense_index.mesh is tm
