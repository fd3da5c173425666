"""The port's hashed-segment lexical top-k (#11's entry,
`persian_rag_tpu_torch.ops.sparse_scores.sparse_topk_hashed`) against the
JAX package's `sparse_topk_hashed_pallas` (Pallas interpret), on the CPU,
at the edges that #11's query table has on the card: a term repeated
within a query and one shared across queries, an all-pad query, a term no
document holds, mass ties, B not a multiple of a query block (13), N not a
multiple of a corpus tile (600 = 2 x 256 + 88 = 4 x 128 + 88), and k = 1,
10 and past a tile (300 > 256). The port runs the plain version (CPU
tensors), which the card's kernel equals bit for bit (chip_smoke.py's
lexkernel and lexedge lines).

Dyadic values (multiples of 1/64, small) make every f32 sum exact, so
scores and ids, tie order included (lower id first), must be EQUAL.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jss = importlib.import_module("persian_rag_tpu.ops.sparse_scores")
tss = importlib.import_module("persian_rag_tpu_torch.ops.sparse_scores")

N_DOCS, ROW, VOCAB, B, T = 600, 24, 200, 13, 16
UNHELD = VOCAB - 1  # a term of the vocabulary that no document holds


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _corpus(rng):
    """(N, L) dyadic ELL, unique ids per row from VOCAB - 1 terms; every
    fourth row from 7 on copies row 3 (mass ties above 0)."""
    ids = np.full((N_DOCS, ROW), -1, np.int32)
    vals = np.zeros((N_DOCS, ROW), np.float32)
    for d in range(N_DOCS):
        nt = int(rng.integers(1, ROW + 1))
        ids[d, :nt] = rng.choice(UNHELD, nt, replace=False)
        vals[d, :nt] = rng.integers(1, 192, nt) / 64.0
    for d in range(7, N_DOCS, 4):
        ids[d], vals[d] = ids[3], vals[3]
    return ids, vals


def _queries(rng, ids):
    """(B, T) batch at the table's edges (the docstring's list)."""
    qids = np.full((B, T), -1, np.int32)
    qvals = np.zeros((B, T), np.float32)
    for i in range(B):
        nt = int(rng.integers(1, T + 1))
        qids[i, :nt] = rng.choice(VOCAB, nt, replace=True)
        qvals[i, :nt] = rng.integers(1, 128, nt) / 64.0
    qids[0, :3] = ids[3, :3]          # row 3's copies tie exactly
    qids[1], qvals[1] = -1, 0.0       # an all-pad query
    qids[2, :3] = [17, 5, 17]         # a term twice in one query ...
    qids[3, :2] = [17, 40]            # ... and shared by another
    qids[4, :2] = [UNHELD, 10_000]    # terms no document holds
    qids[5, :] = -1                   # only a term that no document holds
    qids[5, 0], qvals[5, 0] = UNHELD, 1.0
    return qids, qvals


@pytest.mark.parametrize("n_segments", [4, 8])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_hashed_entry_equals_pallas_interpret(k, n_segments):
    rng = np.random.default_rng(100 * n_segments + k)
    ids, vals = _corpus(rng)
    qids, qvals = _queries(rng, ids)
    ids3, vals3 = tss.hash_segments(ids, vals, n_segments)
    want_s, want_i = jss.sparse_topk_hashed_pallas(
        jnp.asarray(ids3), jnp.asarray(vals3), jnp.asarray(qids),
        jnp.asarray(qvals), k=k, tile_n=128, tile_b=8, interpret=True)
    got_s, got_i = tss.sparse_topk_hashed(_t(ids3), _t(vals3), _t(qids),
                                          _t(qvals), k)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == (B, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # queries that reach no document rank every one at 0, lowest id first
    for row in (1, 5):
        assert (got_s[row] == 0).all()
        np.testing.assert_array_equal(got_i[row].numpy(), np.arange(k))
    # the term held twice in query 2 counts in both of its slots
    full = tss.sparse_scores_ref(_t(ids3.reshape(N_DOCS, -1)),
                                 _t(vals3.reshape(N_DOCS, -1)), _t(qids),
                                 _t(qvals))
    once = qids.copy()
    once[2, 2] = -1
    part = tss.sparse_scores_ref(_t(ids3.reshape(N_DOCS, -1)),
                                 _t(vals3.reshape(N_DOCS, -1)), _t(once),
                                 _t(qvals))
    held = ids == 17
    docs17 = held.any(axis=1)
    v17 = vals[held]
    np.testing.assert_array_equal(
        (full[2] - part[2]).numpy()[docs17], qvals[2, 2] * v17)


def test_lex_ab_needs_a_card(capsys):
    """The same-call timing script of the per-term lexical kernels
    measures on the card only: without CUDA it stops before building."""
    from persian_rag_tpu_torch.scripts import lex_ab

    assert lex_ab.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert lex_ab.CHIP_SMOKE.name == "chip_smoke.py"
    assert lex_ab.CHIP_SMOKE.exists()


def test_lex_ab_compares_saved_outputs(tmp_path, capsys):
    """`--compare` counts, by kernel, the outputs two saved runs share bit
    for bit (the keys both runs hold)."""
    from persian_rag_tpu_torch.scripts import lex_ab

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"sparse_topk_hashed 1": "x",
                             "sparse_topk_hashed 64": "y",
                             "sparse_topk 64": "z", "sparse_topk 512": "q"}))
    b.write_text(json.dumps({"sparse_topk_hashed 1": "x",
                             "sparse_topk_hashed 64": "other",
                             "sparse_topk 64": "z"}))
    assert lex_ab.main(["--compare", str(a), str(b)]) == 0
    lines = [json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines()]
    assert lines == [
        {"kernel": "sparse_topk", "outputs": 1, "bit_equal": 1},
        {"kernel": "sparse_topk_hashed", "outputs": 2, "bit_equal": 1}]
