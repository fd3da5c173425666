"""Lexical top-k above one corpus tile (k > 128) in the port, against the
JAX package, on the CPU.

On the card each sparse kernel lists the top kt = min(k, tile) documents of
every corpus tile (256 documents for #11, 32 to 256 for #10 as its C entry
picks, 128 for the union kernels; id -1 and score -3e38 past a short last
tile) and the
wrapper merges the tiles with a stable sort (`_merge_tiles`). A tile
cannot give more documents than it holds, so for k above the tile each
tile gives all of them and the merge is exact. Here the per-tile lists are
made from the plain scores in the kernels' format and merged by the
wrapper's own `_merge_tiles`; the entries and the retrieval system run the
plain versions (CPU tensors).

Dyadic values (multiples of 1/64, small) make every f32 sum exact, so ids
and scores must be EQUAL to the JAX `sparse_topk` (lax.top_k: lower id
first on ties), mass ties at score 0 included. The retrieval-level cases
hold the port to the JAX RetrievalSystem with the hybrid suite's rule:
scores within rtol 1e-5, ids equal wherever neighbouring scores are more
than 1e-5 apart or tie exactly.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.retrieval.system import RetrievalSystem as JaxRetrieval
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
from persian_rag_tpu_torch.serve.api import RetrievalServer, _Pending

from test_torch_hybrid import (  # noqa: F401  (fixture)
    _systems,
    _texts,
    assert_rows_match,
    encoders,
)

jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

# a tile's pad entry, as csrc/sparse_topk.cu writes it
PAD_SCORE, PAD_ID = -3.0e38, -1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _corpus(rng, n=700, el=12, vocab=80):
    """(N, L) dyadic ELL, unique term ids per row; a quarter of the rows
    copy row 3 (mass ties above 0) and most rows miss a query's terms
    (mass ties at 0)."""
    ids = np.full((n, el), -1, np.int32)
    vals = np.zeros((n, el), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, el + 1))
        ids[d, :nt] = rng.choice(vocab, nt, replace=False)
        vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
    for d in range(7, n, 4):
        ids[d], vals[d] = ids[3], vals[3]
    qids = np.full((6, 5), -1, np.int32)
    qvals = np.zeros((6, 5), np.float32)
    for i in range(6):
        nt = int(rng.integers(1, 6))
        qids[i, :nt] = rng.choice(vocab, nt, replace=False)
        qvals[i, :nt] = rng.integers(1, 128, nt) / 64.0
    qids[0, :3] = ids[3, :3]
    qids[5] = -1  # no term: every document scores 0
    return ids, vals, qids, qvals


def _tile_lists(scores: torch.Tensor, tile: int, kt: int):
    """The kernels' per-tile output from (B, N) scores: (B, J, kt) lists of
    each tile's top kt by (score descending, id ascending), pad entries
    past a short last tile."""
    b, n = scores.shape
    n_tiles = -(-n // tile)
    out_s = torch.full((b, n_tiles, kt), PAD_SCORE, dtype=torch.float32)
    out_i = torch.full((b, n_tiles, kt), PAD_ID, dtype=torch.int32)
    for j in range(n_tiles):
        blk = scores[:, j * tile:(j + 1) * tile]
        s, pos = torch.sort(blk, dim=1, descending=True, stable=True)
        m = min(kt, blk.shape[1])
        out_s[:, j, :m] = s[:, :m]
        out_i[:, j, :m] = (pos[:, :m] + j * tile).int()
    return out_s, out_i


@pytest.mark.parametrize("k", [200, 700])
@pytest.mark.parametrize("tile", [256, 128, 64, 32])
def test_merge_of_whole_tiles_equals_jax(tile, k):
    """Tiles of 256 (per-term), 128 (union, and #10's smaller picks with 64
    and 32), kt = min(k, tile): whole tiles wherever k passes the tile. The
    wrapper's merge equals the JAX sparse_topk at k = 200 and at k = N,
    across a short last tile (700 = 2 x 256 + 188 = 5 x 128 + 60 = 10 x 64
    + 60 = 21 x 32 + 28)."""
    rng = np.random.default_rng(tile + k)
    ids, vals, qids, qvals = _corpus(rng)
    n = ids.shape[0]
    scores = tss.sparse_scores_ref(_t(ids), _t(vals), _t(qids), _t(qvals))
    kt = tss._tile_k(k, tile)
    assert kt == min(k, tile)
    got_s, got_i = tss._merge_tiles(*_tile_lists(scores, tile, kt), k)
    want_s, want_i = jss.sparse_topk(*map(jnp.asarray, (ids, vals, qids,
                                                        qvals)), k)
    assert got_s.shape == (6, min(k, n))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the all-pad query ranks every document at 0, lowest id first
    np.testing.assert_array_equal(got_i[5].numpy(), np.arange(min(k, n)))


@pytest.mark.parametrize("name", list(tss.KERNELS))
def test_kernel_guard_admits_large_k_and_refuses_zero(name):
    """The wrappers check the per-tile kt against the tile, not k: k = 200
    passes the guard (and stops at the device check on CPU tensors), k = 0
    is refused before any device work; no launch is counted."""
    assert tss._tile_k(200, 256) == 200
    assert tss._tile_k(200, 128) == 128
    assert tss._tile_k(1, 128) == 1
    rng = np.random.default_rng(12)
    ids, vals, qids, qvals = _corpus(rng, n=40, el=4, vocab=20)
    docs = (tss.hash_segments(ids, vals, 2) if "hashed" in name
            else (ids, vals))
    args = (*map(_t, docs), _t(qids), _t(qvals))
    before = tss.KERNELS[name].launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.KERNELS[name](*args, 200)
    for k in (0, -3):
        with pytest.raises(ValueError, match="at least 1"):
            tss.KERNELS[name](*args, k)
    assert tss.KERNELS[name].launches == before


@pytest.mark.parametrize("name", list(tss.KERNELS))
def test_entries_at_k_200_equal_jax(name):
    """Each dispatching entry at k = 200 over 700 documents equals the JAX
    sparse_topk (the union kernels sum in another order: exact on dyadic
    values)."""
    rng = np.random.default_rng(13 + list(tss.KERNELS).index(name))
    ids, vals, qids, qvals = _corpus(rng)
    want_s, want_i = jss.sparse_topk(*map(jnp.asarray, (ids, vals, qids,
                                                        qvals)), 200)
    docs = (tss.hash_segments(ids, vals, 4) if "hashed" in name
            else (ids, vals))
    got_s, got_i = getattr(tss, name)(*map(_t, docs), _t(qids), _t(qvals),
                                      200)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# -- retrieval and serving at k > 128 ---------------------------------------------


@pytest.fixture(scope="module")
def big_corpus():
    """260 chunks, so that k = 200 and a hybrid over-retrieve of 2 x 100
    reach past one union tile and stay inside the corpus."""
    rng = np.random.default_rng(41)
    chunks = [{"id": f"c{i}", "text": t, "chunk_type": "word_based"}
              for i, t in enumerate(_texts(rng, 260, 4, 24))]
    chunks[150]["text"] = chunks[9]["text"]  # a duplicate: exact ties
    queries = _texts(rng, 6, 1, 5) + [chunks[9]["text"]]
    return chunks, queries


@pytest.mark.parametrize("method", ["bm25", "tfidf"])
def test_lexical_search_at_k_200_equals_jax(big_corpus, method):
    chunks, queries = big_corpus
    j = JaxRetrieval(method=method)
    t = RetrievalSystem(method=method, device="cpu")
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)
    got = t.retrieve_batch(queries, 200)
    want = j.retrieve_batch(queries, 200)
    assert all(len(r) == 200 for r in got)
    assert_rows_match(got, want)


def test_server_group_answers_each_top_k(big_corpus):
    """A micro-batch of requests at top_k 3, 150 and 200 is served at its
    largest top_k (200) in one retrieve_batch; every request gets its own
    top_k, the prefix of the JAX system's list."""
    chunks, queries = big_corpus
    j = JaxRetrieval(method="bm25")
    t = RetrievalSystem(method="bm25", device="cpu")
    assert j.load_chunks_and_index(chunks) and t.load_chunks_and_index(chunks)
    calls = []
    orig = t.retrieve_batch

    def spy(qs, top_k=10):
        calls.append((list(qs), top_k))
        return orig(qs, top_k)

    t.retrieve_batch = spy
    server = RetrievalServer(t)
    try:
        group = [_Pending(queries[:2], 3), _Pending(queries[2:5], 150),
                 _Pending(queries[5:], 200)]
        server._serve_group(group)
    finally:
        server._server.server_close()
    assert [k for _, k in calls] == [200] and server.batches_served == 1
    for pending in group:
        assert pending.error is None and pending.event.is_set()
        want = j.retrieve_batch(pending.queries, pending.top_k)
        assert [len(r) for r in pending.results] == [pending.top_k] * len(
            pending.queries)
        assert_rows_match(
            [[({"id": h["id"]}, h["score"]) for h in r]
             for r in pending.results], want)


def test_hybrid_at_top_k_100_equals_jax(encoders, big_corpus):
    """The hybrid over-retrieves 2 x 100 = 200 from each channel: the
    fused device chain and the host loop both equal the JAX package's."""
    chunks, queries = big_corpus
    j, t = _systems(encoders, chunks)
    assert t._hybrid_fused_supported()
    for fused in (True, False):
        got = t.retrieve_hybrid_batch(queries, top_k=100, fused=fused)
        want = j.retrieve_hybrid_batch(queries, top_k=100, fused=fused)
        assert all(len(r) == 100 for r in got)
        assert_rows_match(got, want)
