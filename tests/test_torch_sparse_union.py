"""#12, the union kernel over the flat ELL (`sparse_topk_union`), on the CPU.

The card's kernel (csrc/sparse_topk.cu, `sparse_topk_union_walk_kernel`)
walks the documents: a block gives each query its distinct terms in
ascending id order, which is the order of the batch's union, with the
weight `union_prep`'s qw holds (a term held twice summed from +0 in slot
order), and a document's score for the query is one f32 chain over the
terms that the query and the document share, in that order. The earlier
kernel ran the chain over EVERY union term, adding qw * 0 or 0 * value for
the terms the pair does not share. Those steps add an exact zero to a chain
that is never -0, so the two chains are equal bit for bit. Here:

* `walk_scores`, a plain model of the walk (per query its distinct terms,
  per document only its hits, in ascending union order, each product added
  with mul then add in f32), equals the dense chain over every union term
  in the same order bit for bit, on random (not dyadic) values, rows whose
  ids are in no order, a union past one 64-term chunk with -2 pads, B = 13
  and B * T >= 1,024;
* its query terms and weights equal `union_prep`'s u_ids order and qw;
* with dyadic values (every f32 sum exact) its top-k, and the port's
  entry's, equal the JAX package's `sparse_topk_union_pallas` (interpret)
  in scores, ids and tie order at k = 1, 10, 200 over N = 20 and 600 (no
  multiple of any doc tile), with a term repeated within a query and one
  shared across queries, an all-pad query, a term no document holds, and
  mass ties.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

ROW, VOCAB = 24, 200
UNHELD = VOCAB - 1  # a term of the vocabulary that no document holds
CHUNK = tss.UNION_CHUNK


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _value(rng, n, dyadic):
    if dyadic:
        return (rng.integers(1, 192, n) / 64.0).astype(np.float32)
    return rng.uniform(0.01, 3.0, n).astype(np.float32)


def _corpus(rng, n, dyadic):
    """(N, L) ELL, unique ids per row in no order, from VOCAB - 1 terms;
    every fourth row from 7 on copies row 3 (mass ties above 0)."""
    ids = np.full((n, ROW), -1, np.int32)
    vals = np.zeros((n, ROW), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, ROW + 1))
        ids[d, :nt] = rng.choice(UNHELD, nt, replace=False)
        vals[d, :nt] = _value(rng, nt, dyadic)
    for d in range(7, n, 4):
        ids[d], vals[d] = ids[3], vals[3]
    assert (np.diff(ids[:, :2], axis=1) < 0).any()  # rows in no order
    return ids, vals


def _queries(rng, ids, b, t, dyadic):
    """(B, T) batch at the edges of the docstring's list."""
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for i in range(b):
        nt = int(rng.integers(1, t + 1))
        qids[i, :nt] = rng.choice(VOCAB, nt, replace=True)
        qvals[i, :nt] = _value(rng, nt, dyadic)
    qids[0, :3] = ids[3, :3]          # row 3's copies tie exactly
    qids[1], qvals[1] = -1, 0.0       # an all-pad query
    qids[2, :3] = [17, 5, 17]         # a term twice in one query ...
    qids[3, :2] = [17, 40]            # ... and shared by another
    qids[4, :2] = [UNHELD, 10_000]    # terms no document holds
    qids[5, :] = -1                   # only a term that no document holds
    qids[5, 0], qvals[5, 0] = UNHELD, 1.0
    return qids, qvals


def query_terms(qids, qvals):
    """Each query's distinct terms in ascending id order and their weights
    (the query's values for the term summed from +0 in slot order, f32):
    the slot map the kernel's block builds."""
    out = []
    for row_ids, row_vals in zip(qids, qvals):
        w = {}
        for tid, v in zip(row_ids.tolist(), row_vals):
            if tid >= 0:
                w[tid] = np.float32(w.get(tid, np.float32(0)) + v)
        out.append(sorted(w.items()))
    return out


def walk_scores(ids, vals, qids, qvals):
    """(B, N) f32: per (query, document) one chain from +0 over the terms
    both hold, in ascending id order, acc = acc + w * v (mul then add)."""
    n = ids.shape[0]
    col = {}  # term -> (docs holding it, their values)
    for d, row in enumerate(ids):
        for slot, tid in enumerate(row.tolist()):
            if tid >= 0:
                col.setdefault(tid, ([], []))
                col[tid][0].append(d)
                col[tid][1].append(vals[d, slot])
    out = np.zeros((len(qids), n), np.float32)
    for b, terms in enumerate(query_terms(qids, qvals)):
        acc = np.zeros(n, np.float32)
        for tid, w in terms:
            if tid not in col:
                continue
            docs = np.asarray(col[tid][0])
            acc[docs] = acc[docs] + w * np.asarray(col[tid][1], np.float32)
        out[b] = acc
    return out


def dense_chain(ids, vals, qids, qvals):
    """(B, N) f32: the earlier kernel's chain over every union term of
    `union_prep` in ascending order, acc = acc + qw[b, a] * D[a, n]."""
    u_ids, qw, n_chunks = tss.union_prep(_t(qids), _t(qvals), CHUNK)
    u = u_ids.reshape(-1)
    n_real = int((u >= 0).sum())
    assert n_real <= int(n_chunks) * CHUNK
    qw_bu = qw.permute(1, 0, 2).reshape(qids.shape[0], -1)
    d = tss._term_columns(_t(ids), _t(vals), u[:n_real].long())
    acc = torch.zeros((qids.shape[0], ids.shape[0]), dtype=torch.float32)
    for a in range(n_real):
        acc = acc + qw_bu[:, a, None] * d[a][None, :]
    return acc.numpy()


def _stable_top(scores, k):
    pos = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, pos, 1), pos.astype(np.int32)


SHAPES = [(600, 13, 16), (600, 128, 8), (20, 13, 16)]


@pytest.mark.parametrize("n, b, t", SHAPES)
def test_walk_equals_dense_chain_bit_for_bit(n, b, t):
    rng = np.random.default_rng(n + 7 * b + t)
    ids, vals = _corpus(rng, n, dyadic=False)
    qids, qvals = _queries(rng, ids, b, t, dyadic=False)
    u_ids, _, n_chunks = tss.union_prep(_t(qids), _t(qvals), CHUNK)
    if b * t >= 1024:  # past one chunk, -2 pads at the last one's end
        assert int(n_chunks) > 1 and int(u_ids.reshape(-1)[-1]) == -2
    walk = walk_scores(ids, vals, qids, qvals)
    np.testing.assert_array_equal(walk.view(np.int32),
                                  dense_chain(ids, vals, qids, qvals)
                                  .view(np.int32))


@pytest.mark.parametrize("n, b, t", SHAPES)
def test_query_terms_are_union_prep_order_and_weights(n, b, t):
    """The block's slot map: ascending ids are the union's order, and each
    weight is the qw entry of its (query, union term), bit for bit."""
    rng = np.random.default_rng(3 * n + b + t)
    ids, _ = _corpus(rng, n, dyadic=False)
    qids, qvals = _queries(rng, ids, b, t, dyadic=False)
    u_ids, qw, _ = tss.union_prep(_t(qids), _t(qvals), CHUNK)
    u = u_ids.reshape(-1).numpy()
    qw_bu = qw.permute(1, 0, 2).reshape(b, -1).numpy()
    index = {int(tid): a for a, tid in enumerate(u) if tid >= 0}
    for q, terms in enumerate(query_terms(qids, qvals)):
        slots = [index[tid] for tid, _ in terms]
        assert slots == sorted(slots)
        got = np.asarray([w for _, w in terms], np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      qw_bu[q, slots].view(np.int32))
        # every other union term weighs 0 for this query
        rest = np.setdiff1d(np.arange(qw_bu.shape[1]), slots)
        assert not qw_bu[q, rest].any()


def _jax(ids, vals, qids, qvals, k):
    s, i = jss.sparse_topk_union_pallas(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(qids),
        jnp.asarray(qvals), k=min(k, ids.shape[0]), tile_n=128, u_chunk=32,
        interpret=True)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n, b, t", SHAPES)
@pytest.mark.parametrize("k", [1, 10, 200])
def test_walk_and_entry_equal_pallas_interpret(n, b, t, k):
    rng = np.random.default_rng(11 * n + b + k)
    ids, vals = _corpus(rng, n, dyadic=True)
    qids, qvals = _queries(rng, ids, b, t, dyadic=True)
    want_s, want_i = _jax(ids, vals, qids, qvals, k)
    walk_s, walk_i = _stable_top(walk_scores(ids, vals, qids, qvals),
                                 min(k, n))
    np.testing.assert_array_equal(walk_i, want_i)
    np.testing.assert_array_equal(walk_s, want_s)
    got_s, got_i = tss.sparse_topk_union(_t(ids), _t(vals), _t(qids),
                                         _t(qvals), k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # queries that reach no document rank every one at 0, lowest id first
    for row in (1, 5):
        assert (got_s[row] == 0).all()
        np.testing.assert_array_equal(got_i[row].numpy(),
                                      np.arange(min(k, n)))


def test_union_kernel_needs_cuda_tensors():
    """On CPU tensors the kernel's wrapper raises before any build: the
    entry takes the plain version there, and nothing falls back."""
    rng = np.random.default_rng(5)
    ids, vals = _corpus(rng, 20, dyadic=True)
    qids, qvals = _queries(rng, ids, 13, 16, dyadic=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.sparse_topk_union_cuda(_t(ids), _t(vals), _t(qids), _t(qvals), 10)
    with pytest.raises(ValueError, match="at least 1"):
        tss.sparse_topk_union_cuda(_t(ids), _t(vals), _t(qids), _t(qvals), 0)
