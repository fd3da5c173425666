"""Stage 1 of #12 and #13 (`sparse_topk_union(..., stage1=True)` and
`sparse_topk_union_hashed(..., stage1=True)`), the candidate pass of
two-pass union serving, on the CPU.

The card's kernels round each query's merged union weight (`union_prep`'s
qw) and each matched document value to bf16, to nearest even, and run the
union walk's f32 chain over the terms that the query and the document
share, in the union's order (ascending id; hashed: (id % S, id)). Here:

* `stage1_scores`, a numpy model of that chain (bf16 rounding by JAX's own
  cast), equals the plain versions' scores and ids bit for bit, flat and
  hashed (S = 4 and 8), on random values at B = 13 and B * T >= 1,024;
* with dyadic values of 8 significant bits (exact in bf16, every f32 sum
  exact) the plain versions equal the JAX kernels with stage1=True in
  interpret mode in scores, ids and tie order;
* on random values they agree with the JAX kernels in interpret mode to
  the stage-1 envelope: |port - JAX| <= 2 * 2^-9 * the exact score (both
  round the same bf16 operands; only the f32 order of the sum differs), ids
  equal but where JAX's neighbouring scores (the k_scan cut included) lie
  within that envelope.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

ROW, VOCAB = 24, 200
K_SCAN = 32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
                      np.float32)


def _value(rng, n, dyadic):
    if dyadic:
        return (rng.integers(1, 256, n) / 64.0).astype(np.float32)
    return rng.uniform(0.01, 3.0, n).astype(np.float32)


def _corpus(rng, n, dyadic):
    """(N, L) ELL, unique ids per row in no order; every fifth row from 6 on
    copies row 2 (ties)."""
    ids = np.full((n, ROW), -1, np.int32)
    vals = np.zeros((n, ROW), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, ROW + 1))
        ids[d, :nt] = rng.choice(VOCAB - 1, nt, replace=False)
        vals[d, :nt] = _value(rng, nt, dyadic)
    for d in range(6, n, 5):
        ids[d], vals[d] = ids[2], vals[2]
    return ids, vals


def _queries(rng, b, t, dyadic):
    qids = np.full((b, t), -1, np.int32)
    qvals = np.zeros((b, t), np.float32)
    for i in range(b):
        nt = int(rng.integers(1, t + 1))
        qids[i, :nt] = rng.choice(VOCAB, nt, replace=True)
        qvals[i, :nt] = _value(rng, nt, dyadic)
    qids[1], qvals[1] = -1, 0.0       # an all-pad query
    qids[2, :3] = [17, 5, 17]         # a term twice in one query ...
    qids[3, :2] = [17, 40]            # ... and shared by another
    return qids, qvals


def stage1_scores(ids, vals, qids, qvals, s_n):
    """(B, N) f32: per (query, doc) one chain from +0 over the query's
    distinct terms in union order ((id % S, id); S = 1: ascending id), the
    query's weight for a term summed in slot order then rounded to bf16,
    acc = acc + bf16(w) * bf16(v) where the doc holds the term."""
    n = ids.shape[0]
    at = [{tid: v for tid, v in zip(r.tolist(), vr) if tid >= 0}
          for r, vr in zip(ids, vals)]
    out = np.zeros((len(qids), n), np.float32)
    for b, (row_ids, row_vals) in enumerate(zip(qids, qvals)):
        w = {}
        for tid, v in zip(row_ids.tolist(), row_vals):
            if tid >= 0:
                w[tid] = np.float32(w.get(tid, np.float32(0)) + v)
        terms = sorted(w, key=lambda tid: (tid % s_n, tid))
        for d in range(n):
            acc = np.float32(0)
            for tid in terms:
                if tid in at[d]:
                    prod = _bf16(w[tid]) * _bf16(at[d][tid])
                    acc = np.float32(acc + np.float32(prod))
            out[b, d] = acc
    return out


def _stable_top(scores, k):
    pos = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, pos, 1), pos.astype(np.int32)


def _port(ids, vals, qids, qvals, k, s_n):
    if s_n == 1:
        s, i = tss.sparse_topk_union(_t(ids), _t(vals), _t(qids), _t(qvals),
                                     k, stage1=True)
        return s.numpy(), i.numpy()
    ids3, vals3 = tss.hash_segments(ids, vals, s_n)
    s, i = tss.sparse_topk_union_hashed(_t(ids3), _t(vals3), _t(qids),
                                        _t(qvals), k, stage1=True)
    return s.numpy(), i.numpy()


def _jax(ids, vals, qids, qvals, k, s_n):
    if s_n == 1:
        s, i = jss.sparse_topk_union_pallas(
            jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(qids),
            jnp.asarray(qvals), k=k, tile_n=128, u_chunk=32, interpret=True,
            stage1=True)
    else:
        ids3, vals3 = jss.hash_segments(ids, vals, s_n)
        s, i = jss.sparse_topk_union_hashed_pallas(
            jnp.asarray(ids3), jnp.asarray(vals3), jnp.asarray(qids),
            jnp.asarray(qvals), k=k, tile_n=128, u_chunk=32, interpret=True,
            stage1=True)
    return np.asarray(s), np.asarray(i)


LAYOUTS = [1, 4, 8]


@pytest.mark.parametrize("s_n", LAYOUTS)
@pytest.mark.parametrize("n, b, t", [(150, 13, 16), (90, 128, 8)])
def test_plain_stage1_equals_model_bit_for_bit(s_n, n, b, t):
    rng = np.random.default_rng(n + b + s_n)
    ids, vals = _corpus(rng, n, dyadic=False)
    qids, qvals = _queries(rng, b, t, dyadic=False)
    want_s, want_i = _stable_top(stage1_scores(ids, vals, qids, qvals, s_n),
                                 n)
    got_s, got_i = _port(ids, vals, qids, qvals, n, s_n)
    np.testing.assert_array_equal(got_s.view(np.int32), want_s.view(np.int32))
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("s_n", LAYOUTS)
@pytest.mark.parametrize("k", [1, 10, K_SCAN])
def test_stage1_dyadic_equals_pallas_interpret(s_n, k):
    rng = np.random.default_rng(17 * s_n + k)
    ids, vals = _corpus(rng, 300, dyadic=True)
    qids, qvals = _queries(rng, 13, 8, dyadic=True)
    assert np.array_equal(_bf16(vals), vals)  # values exact in bf16
    want_s, want_i = _jax(ids, vals, qids, qvals, k, s_n)
    got_s, got_i = _port(ids, vals, qids, qvals, k, s_n)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("s_n", LAYOUTS)
def test_stage1_random_within_envelope_of_pallas_interpret(s_n):
    rng = np.random.default_rng(29 + s_n)
    n, k = 300, K_SCAN
    ids, vals = _corpus(rng, n, dyadic=False)
    qids, qvals = _queries(rng, 16, 8, dyadic=False)
    want_s, want_i = _jax(ids, vals, qids, qvals, k + 1, s_n)
    got_s, got_i = _port(ids, vals, qids, qvals, k, s_n)
    exact = np.asarray(jss.sparse_scores_ref(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(qids),
        jnp.asarray(qvals)))
    tol = 2 * 2.0 ** -9 * np.abs(exact).max(axis=1, keepdims=True) + 1e-30
    assert (np.abs(got_s - want_s[:, :k]) <= tol).all()
    gaps = np.abs(np.diff(want_s, axis=1))  # (B, k): neighbours' gaps
    near = np.minimum(np.concatenate([np.full((len(gaps), 1), np.inf),
                                      gaps[:, :-1]], axis=1), gaps)
    differ = got_i != want_i[:, :k]
    assert not (differ & (near > 2 * tol)).any()
    assert differ.mean() < 0.1


def test_stage1_counts_apart_from_exact_launches():
    """The wrappers keep a stage-1 count beside the exact one, and on CPU
    tensors raise before any build (the entries take the plain versions
    there)."""
    for fn in (tss.sparse_topk_union_cuda, tss.sparse_topk_union_hashed_cuda):
        assert isinstance(fn.stage1_launches, int)
    rng = np.random.default_rng(5)
    ids, vals = _corpus(rng, 20, dyadic=True)
    qids, qvals = _queries(rng, 13, 8, dyadic=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tss.sparse_topk_union_cuda(_t(ids), _t(vals), _t(qids), _t(qvals),
                                   10, stage1=True)
