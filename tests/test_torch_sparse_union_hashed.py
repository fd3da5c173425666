"""#13, the union kernel over the hashed segments
(`sparse_topk_union_hashed`), and the walk past a block's query slots, on
the CPU.

The card's kernel (csrc/sparse_topk.cu, `sparse_topk_union_lookup_kernel`)
walks the documents as #11 does, a document's S * Ls slots read as one
row: a block gives each query its distinct terms in the union's order,
which `union_prep_hashed` sorts by (tid % S, tid), with the weight its qw
holds (a term held twice summed from +0 in slot order), and a document's
score for the query is one f32 chain over the terms that the query and the
document share, in that order. The earlier kernel ran the chain over EVERY
union term, chunk after chunk of one segment each, adding qw * 0 or 0 *
value for the terms the pair does not share. Those steps add an exact zero
to a chain that is never -0, so the two chains are equal bit for bit. Here:

* `walk_scores`, a plain model of the walk (per query its distinct terms
  by (tid % S, tid), per document only its hits, each product added with
  mul then add in f32), equals the dense chain over every slot of
  `union_prep_hashed`'s chunks (segment pads included) bit for bit, on
  random (not dyadic) values, rows whose ids are in no order, a term twice
  in a query, unions past one 64-term chunk, S = 4 and 8;
* its query terms and weights equal `union_prep_hashed`'s order and qw;
* with dyadic values (every f32 sum exact) its top-k, and the port's
  entry's, equal the JAX package's `sparse_topk_union_hashed_pallas`
  (interpret) in scores, ids and tie order at k = 1, 10, 200;
* past the slots a block holds (T ~6,200) the walk runs in passes of
  query ranks, carrying each chain from pass to pass: a model of the
  passes (ranks counted over every live slot, so a term held twice leaves
  a pad) equals the one-pass walk bit for bit at every pass size;
* at T = 6,208 every entry, flat or hashed, per term or union, keeps its
  own kernel and plain version, whose top-k equals the JAX package's
  `sparse_topk` / `sparse_topk_hashed` (dyadic values).
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


def _corpus(rng, n, s_n, dyadic, vocab=VOCAB):
    """(N, S, Ls) hashed ELL from an (N, L) one with unique ids per row in
    no order, from vocab - 1 terms; every fourth row from 7 on copies row 3
    (mass ties above 0)."""
    ids = np.full((n, ROW), -1, np.int32)
    vals = np.zeros((n, ROW), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, ROW + 1))
        ids[d, :nt] = rng.choice(vocab - 1, nt, replace=False)
        vals[d, :nt] = _value(rng, nt, dyadic)
    for d in range(7, n, 4):
        ids[d], vals[d] = ids[3], vals[3]
    assert (np.diff(ids[:, :2], axis=1) < 0).any()  # rows in no order
    ids3, vals3 = tss.hash_segments(ids, vals, s_n)
    return ids, vals, ids3, vals3


def _queries(rng, ids, b, t, dyadic, vocab=VOCAB):
    """(B, T) batch: a term repeated within a query and one shared across
    queries, an all-pad query, terms no document holds, exact ties."""
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for i in range(b):
        nt = int(rng.integers(1, t + 1))
        qids[i, :nt] = rng.choice(vocab, nt, replace=True)
        qvals[i, :nt] = _value(rng, nt, dyadic)
    qids[0, :3] = ids[3, :3]          # row 3's copies tie exactly
    qids[1], qvals[1] = -1, 0.0       # an all-pad query
    qids[2, :3] = [17, 5, 17]         # a term twice in one query ...
    qids[3, :2] = [17, 40]            # ... and shared by another
    qids[4, :2] = [vocab - 1, 10_000]  # terms no document holds
    return qids, qvals


def query_terms(qids, qvals, s_n):
    """Each query's distinct terms by (tid % S, tid) and their weights (the
    query's values for the term summed from +0 in slot order, f32): the
    slot map the kernel's block builds."""
    out = []
    for row_ids, row_vals in zip(qids, qvals):
        w = {}
        for tid, v in zip(row_ids.tolist(), row_vals):
            if tid >= 0:
                w[tid] = np.float32(w.get(tid, np.float32(0)) + v)
        out.append(sorted(w.items(), key=lambda e: (e[0] % s_n, e[0])))
    return out


def walk_scores(ids, vals, qids, qvals, s_n):
    """(B, N) f32: per (query, document) one chain from +0 over the terms
    both hold, by (tid % S, tid), acc = acc + w * v (mul then add)."""
    n = ids.shape[0]
    col = {}  # term -> (docs holding it, their values)
    for d, row in enumerate(ids):
        for slot, tid in enumerate(row.tolist()):
            if tid >= 0:
                col.setdefault(tid, ([], []))
                col[tid][0].append(d)
                col[tid][1].append(vals[d, slot])
    out = np.zeros((len(qids), n), np.float32)
    for b, terms in enumerate(query_terms(qids, qvals, s_n)):
        acc = np.zeros(n, np.float32)
        for tid, w in terms:
            if tid not in col:
                continue
            docs = np.asarray(col[tid][0])
            acc[docs] = acc[docs] + w * np.asarray(col[tid][1], np.float32)
        out[b] = acc
    return out


def dense_chain(ids3, vals3, qids, qvals, s_n):
    """(B, N) f32: the earlier kernel's chain over every slot of
    `union_prep_hashed`'s populated chunks in order (-2 pads weigh 0 and
    match no document), acc = acc + qw[b, a] * D[a, n]."""
    u_ids, qw, _, n_chunks = tss.union_prep_hashed(_t(qids), _t(qvals),
                                                   CHUNK, s_n)
    used = int(n_chunks) * CHUNK
    u = u_ids.reshape(-1)[:used].long()
    qw_bu = qw.permute(1, 0, 2).reshape(qids.shape[0], -1)[:, :used]
    n = ids3.shape[0]
    flat_ids = _t(ids3).reshape(n, -1)
    flat_vals = _t(vals3).reshape(n, -1)
    order = torch.argsort(u, stable=True)
    d_sorted = tss._term_columns(flat_ids, flat_vals, u[order])
    d = torch.empty_like(d_sorted)
    d[order] = d_sorted
    acc = torch.zeros((qids.shape[0], n), dtype=torch.float32)
    for a in range(used):
        acc = acc + qw_bu[:, a, None] * d[a][None, :]
    return acc.numpy(), u_ids, int(n_chunks)


def _stable_top(scores, k):
    pos = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, pos, 1), pos.astype(np.int32)


SHAPES = [(600, 13, 16, 8), (600, 128, 8, 8), (300, 64, 24, 4),
          (20, 13, 16, 8)]


@pytest.mark.parametrize("n, b, t, s_n", SHAPES)
def test_walk_equals_dense_chain_bit_for_bit(n, b, t, s_n):
    rng = np.random.default_rng(n + 7 * b + t + s_n)
    big = b * t >= 1024  # a union of ~1,000 terms: segments past one chunk
    vocab = 2_000 if big else VOCAB
    ids, vals, ids3, vals3 = _corpus(rng, n, s_n, dyadic=False, vocab=vocab)
    qids, qvals = _queries(rng, ids, b, t, dyadic=False, vocab=vocab)
    dense, u_ids, n_chunks = dense_chain(ids3, vals3, qids, qvals, s_n)
    if big:  # -2 pads at the segments' ends
        assert n_chunks > s_n and (u_ids.reshape(-1) == -2).any()
    walk = walk_scores(ids, vals, qids, qvals, s_n)
    np.testing.assert_array_equal(walk.view(np.int32), dense.view(np.int32))


@pytest.mark.parametrize("n, b, t, s_n", SHAPES)
def test_query_terms_are_union_prep_hashed_order_and_weights(n, b, t, s_n):
    """The block's slot map: (tid % S, tid) is the union's order, and each
    weight is the qw entry of its (query, union term), bit for bit."""
    rng = np.random.default_rng(3 * n + b + t + s_n)
    ids, _, _, _ = _corpus(rng, n, s_n, dyadic=False)
    qids, qvals = _queries(rng, ids, b, t, dyadic=False)
    u_ids, qw, _, _ = tss.union_prep_hashed(_t(qids), _t(qvals), CHUNK, s_n)
    u = u_ids.reshape(-1).numpy()
    qw_bu = qw.permute(1, 0, 2).reshape(b, -1).numpy()
    index = {int(tid): a for a, tid in enumerate(u) if tid >= 0}
    for q, terms in enumerate(query_terms(qids, qvals, s_n)):
        slots = [index[tid] for tid, _ in terms]
        assert slots == sorted(slots)
        got = np.asarray([w for _, w in terms], np.float32)
        np.testing.assert_array_equal(got.view(np.int32),
                                      qw_bu[q, slots].view(np.int32))
        rest = np.setdiff1d(np.arange(qw_bu.shape[1]), slots)
        assert not qw_bu[q, rest].any()


def _jax(ids3, vals3, qids, qvals, k):
    s, i = jss.sparse_topk_union_hashed_pallas(
        jnp.asarray(ids3), jnp.asarray(vals3), jnp.asarray(qids),
        jnp.asarray(qvals), k=min(k, ids3.shape[0]), tile_n=128, u_chunk=32,
        interpret=True)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n, b, t, s_n", SHAPES[:1] + SHAPES[3:])
@pytest.mark.parametrize("k", [1, 10, 200])
def test_walk_and_entry_equal_pallas_interpret(n, b, t, s_n, k):
    rng = np.random.default_rng(11 * n + b + k + s_n)
    ids, vals, ids3, vals3 = _corpus(rng, n, s_n, dyadic=True)
    qids, qvals = _queries(rng, ids, b, t, dyadic=True)
    want_s, want_i = _jax(ids3, vals3, qids, qvals, k)
    walk_s, walk_i = _stable_top(walk_scores(ids, vals, qids, qvals, s_n),
                                 min(k, n))
    np.testing.assert_array_equal(walk_i, want_i)
    np.testing.assert_array_equal(walk_s, want_s)
    got_s, got_i = tss.sparse_topk_union_hashed(
        _t(ids3), _t(vals3), _t(qids), _t(qvals), k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def walk_passes(ids, vals, qids, qvals, s_n, tc):
    """walk_scores in passes of tc ranks, as the kernel walks a query of
    more slots than a block holds: a term's rank is the count of the
    query's live slots with a smaller (tid % S, tid) (a term held twice
    counts twice and leaves a pad), pass p takes ranks [p tc, (p + 1) tc),
    and each (query, doc) chain carries on from the last pass."""
    n = ids.shape[0]
    held = [dict(zip(row[row >= 0].tolist(), vals[d][row >= 0]))
            for d, row in enumerate(ids)]
    out = np.zeros((len(qids), n), np.float32)
    for b, terms in enumerate(query_terms(qids, qvals, s_n)):
        live = [t for t in qids[b].tolist() if t >= 0]
        ranked = [(sum((x % s_n, x) < (tid % s_n, tid) for x in live), tid, w)
                  for tid, w in terms]
        t_q = qids.shape[1]
        for lo in range(0, t_q, tc):
            for rank, tid, w in ranked:
                if not lo <= rank < lo + tc:
                    continue
                for d in range(n):
                    if tid in held[d]:
                        out[b, d] = out[b, d] + w * held[d][tid]
    return out


@pytest.mark.parametrize("tc", [1, 3, 7, 16])
def test_walk_in_passes_equals_one_pass(tc):
    """Passes of any size give the one-pass walk's bits (random values, a
    term twice in a query, unheld terms)."""
    rng = np.random.default_rng(40 + tc)
    ids, vals, _, _ = _corpus(rng, 60, 8, dyadic=False)
    qids, qvals = _queries(rng, ids, 9, 16, dyadic=False)
    one = walk_scores(ids, vals, qids, qvals, 8)
    got = walk_passes(ids, vals, qids, qvals, 8, tc)
    np.testing.assert_array_equal(got.view(np.int32), one.view(np.int32))


LONG_T, LONG_VOCAB = 6_208, 9_000


@pytest.fixture(scope="module")
def long_batch():
    """Two queries of T = 6,208 slots (one with 6,000 distinct terms) over
    40 documents from a vocabulary of 9,000 terms; dyadic values."""
    rng = np.random.default_rng(62)
    ids, vals, ids3, vals3 = _corpus(rng, 40, 8, dyadic=True,
                                     vocab=LONG_VOCAB)
    qids = np.full((2, LONG_T), -1, np.int32)
    qvals = np.zeros((2, LONG_T), np.float32)
    qids[0, :6_000] = rng.choice(LONG_VOCAB, 6_000, replace=False)
    qids[0, 6_000:6_100] = qids[0, :100]  # terms twice in the query
    qids[1, :] = rng.choice(LONG_VOCAB, LONG_T, replace=True)
    live = qids >= 0
    qvals[live] = _value(rng, int(live.sum()), dyadic=True)
    return ids, vals, ids3, vals3, qids, qvals


@pytest.mark.parametrize("name", ["sparse_topk", "sparse_topk_hashed",
                                  "sparse_topk_union",
                                  "sparse_topk_union_hashed"])
def test_past_one_pass_of_slots_every_entry_keeps_its_own(
        long_batch, name, monkeypatch):
    """Past the slots a block holds each entry keeps its own plain version
    here (its kernel on the card, walked in passes), and answers as the
    JAX package's per-term top-k (exact sums: dyadic values)."""
    ids, vals, ids3, vals3, qids, qvals = long_batch
    hashed = name.endswith("hashed")
    docs = (_t(ids3), _t(vals3)) if hashed else (_t(ids), _t(vals))
    calls = []
    for entry, plain in tss.PLAIN.items():
        def spy(*args, _entry=entry, _plain=plain):
            calls.append(_entry)
            return _plain(*args)
        monkeypatch.setattr(tss, plain.__name__, spy)
    got_s, got_i = getattr(tss, name)(*docs, _t(qids), _t(qvals), 10)
    assert calls[0] == name
    want_s, want_i = jss.sparse_topk(jnp.asarray(ids), jnp.asarray(vals),
                                     jnp.asarray(qids), jnp.asarray(qvals),
                                     10, use_pallas=False)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_union_hashed_kernel_needs_cuda_tensors():
    """On CPU tensors the kernel's wrappers raise before any build: the
    entry takes the plain version there, and nothing falls back."""
    rng = np.random.default_rng(5)
    ids, _, ids3, vals3 = _corpus(rng, 20, 8, dyadic=True)
    qids, qvals = _queries(rng, ids, 13, 16, dyadic=True)
    fn = tss.sparse_topk_union_hashed_cuda
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(_t(ids3), _t(vals3), _t(qids), _t(qvals), 10)
    assert fn.launches == before
    with pytest.raises(ValueError, match="at least 1"):
        tss.sparse_topk_union_hashed_cuda(_t(ids3), _t(vals3), _t(qids),
                                          _t(qvals), 0)
