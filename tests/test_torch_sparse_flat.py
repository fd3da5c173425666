"""The port's flat-ELL lexical top-k (#10's entry,
`persian_rag_tpu_torch.ops.sparse_scores.sparse_topk`) against the JAX
package's `sparse_topk_pallas` (Pallas interpret), on the CPU, at the
edges that #10's lookup has on the card: a corpus below the smallest doc
tile (20 < 32 documents) and one that is no multiple of any tile (600 =
18 x 32 + 24 = 9 x 64 + 24 = 2 x 256 + 88), B = 13 (no multiple of a query
block), a term repeated within a query and one shared across queries, an
all-pad query, a term no document holds, mass ties, k = 1, 10 and past a
tile (300), and a query of T = 3,400 slots, past the earlier kernel's
shared-memory limit (T + L <= 3,376). The port runs the plain version (CPU
tensors), which the card's kernel equals bit for bit (chip_smoke.py's
lexkernel and lexedge lines). The per-tile lists at every tile the card
may take (32 to 256 documents) merge to the same result.

Dyadic values (multiples of 1/64, small) make every f32 sum exact, so scores
and ids, tie order included (lower id first), must be EQUAL.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

ROW, VOCAB, B = 24, 200, 13
UNHELD = VOCAB - 1  # a term of the vocabulary that no document holds
# the earlier #10's limit: 8 x (8 x 256 + 8 T + 8 L) bytes <= 232,448
OLD_LIMIT = 3_376
WIDE_T = 3_400


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _corpus(rng, n):
    """(N, L) dyadic ELL, unique ids per row from VOCAB - 1 terms; every
    fourth row from 7 on copies row 3 (mass ties above 0)."""
    ids = np.full((n, ROW), -1, np.int32)
    vals = np.zeros((n, ROW), np.float32)
    for d in range(n):
        nt = int(rng.integers(1, ROW + 1))
        ids[d, :nt] = rng.choice(UNHELD, nt, replace=False)
        vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
    for d in range(7, n, 4):
        ids[d], vals[d] = ids[3], vals[3]
    return ids, vals


def _queries(rng, ids, t):
    """(B, T) batch at the edges (the docstring's list); with T past 16,
    query 6 fills every slot with distinct terms."""
    qids = np.full((B, t), -1, np.int32)
    qvals = np.zeros((B, t), np.float32)
    for i in range(B):
        nt = int(rng.integers(1, min(t, 16) + 1))
        qids[i, :nt] = rng.choice(VOCAB, nt, replace=True)
        qvals[i, :nt] = rng.integers(1, 128, nt) / 64.0
    qids[0, :3] = ids[3, :3]          # row 3's copies tie exactly
    qids[1], qvals[1] = -1, 0.0       # an all-pad query
    qids[2, :3] = [17, 5, 17]         # a term twice in one query ...
    qids[3, :2] = [17, 40]            # ... and shared by another
    qids[4, :2] = [UNHELD, 10_000]    # terms no document holds
    qids[5, :] = -1                   # only a term that no document holds
    qids[5, 0], qvals[5, 0] = UNHELD, 1.0
    if t > 16:                        # a wide query: distinct ids, most unheld
        qids[6] = np.concatenate([rng.permutation(VOCAB),
                                  VOCAB + rng.permutation(t - VOCAB)])
        qvals[6] = rng.integers(1, 128, t) / 64.0
    return qids, qvals


def _jax(ids, vals, qids, qvals, k):
    s, i = jss.sparse_topk_pallas(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(qids),
        jnp.asarray(qvals), k=min(k, ids.shape[0]), tile_n=128, tile_b=8,
        interpret=True)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n_docs", [20, 600])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_flat_entry_equals_pallas_interpret(n_docs, k):
    rng = np.random.default_rng(7 * n_docs + k)
    ids, vals = _corpus(rng, n_docs)
    qids, qvals = _queries(rng, ids, 16)
    want_s, want_i = _jax(ids, vals, qids, qvals, k)
    got_s, got_i = tss.sparse_topk(_t(ids), _t(vals), _t(qids), _t(qvals), k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == (B, min(k, n_docs))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # queries that reach no document rank every one at 0, lowest id first
    for row in (1, 5):
        assert (got_s[row] == 0).all()
        np.testing.assert_array_equal(got_i[row].numpy(),
                                      np.arange(min(k, n_docs)))
    # the term held twice in query 2 counts in both of its slots
    full = tss.sparse_scores_ref(_t(ids), _t(vals), _t(qids), _t(qvals))
    once = qids.copy()
    once[2, 2] = -1
    part = tss.sparse_scores_ref(_t(ids), _t(vals), _t(once), _t(qvals))
    held = ids == 17
    np.testing.assert_array_equal(
        (full[2] - part[2]).numpy()[held.any(axis=1)],
        qvals[2, 2] * vals[held])


@pytest.mark.parametrize("k", [10, 300])
def test_query_past_the_earlier_limit_equals_pallas_interpret(k):
    """T = 3,400 with rows of 24 slots: past what the earlier #10 took
    (T + L <= 3,376); the lookup's table takes it."""
    assert WIDE_T + ROW > OLD_LIMIT
    rng = np.random.default_rng(31 + k)
    ids, vals = _corpus(rng, 600)
    qids, qvals = _queries(rng, ids, WIDE_T)
    want_s, want_i = _jax(ids, vals, qids, qvals, k)
    got_s, got_i = tss.sparse_topk(_t(ids), _t(vals), _t(qids), _t(qvals), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def _tile_lists(scores, tile, kt):
    """(B, J, kt) per-tile lists as the kernel writes them: each tile's top
    kt by score then lower id; id -1 and score -3e38 past a short tile."""
    b, n = scores.shape
    n_tiles = -(-n // tile)
    out_s = torch.full((b, n_tiles, kt), -3.0e38)
    out_i = torch.full((b, n_tiles, kt), -1, dtype=torch.int32)
    for j in range(n_tiles):
        s, pos = torch.sort(scores[:, j * tile:(j + 1) * tile], dim=1,
                            descending=True, stable=True)
        m = min(kt, s.shape[1])
        out_s[:, j, :m] = s[:, :m]
        out_i[:, j, :m] = (pos[:, :m] + j * tile).int()
    return out_s, out_i


@pytest.mark.parametrize("k", [1, 10, 300])
def test_merged_list_does_not_depend_on_the_tile(k):
    """#10's C entry halves its doc tile (256 down to 32) to fill the card;
    each tile gives its top min(k, tile), and the stable merge of every
    tiling (`_merge_tiles`, whose order the card's merge kernel keeps)
    equals the plain version's list, ties included."""
    rng = np.random.default_rng(50 + k)
    ids, vals = _corpus(rng, 600)
    qids, qvals = _queries(rng, ids, 16)
    scores = tss.sparse_scores_ref(_t(ids), _t(vals), _t(qids), _t(qvals))
    want_s, want_i = tss.sparse_topk_plain(_t(ids), _t(vals), _t(qids),
                                           _t(qvals), k)
    for tile in (256, 128, 64, 32):
        kt = tss._tile_k(k, tile)
        got_s, got_i = tss._merge_tiles(*_tile_lists(scores, tile, kt), k)
        assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i), tile
