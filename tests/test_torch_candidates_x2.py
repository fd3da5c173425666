"""The bf16x2 stage 1 (#2) as the card's kernel computes it, on the CPU.

`flat_topk.bf16x2_chain_scores` mirrors the kernel's arithmetic: one f32
chain from +0 a (query, row), k ascending, three exact bf16 products a k
(q_hi c_hi, q_hi c_lo, q_lo c_hi), each added with one rounding to nearest;
`bf16x2_chain_candidates` turns it into the kernel's slots, which the card's
kernel equals bit for bit (chip_smoke.py's kernel and x2edge lines). At the
reference encoders' widths (384, 512, 768) and an odd one, for dot and l2,
the chain's scores lie within `_bf16x2_matmul_eps(d)` ||q|| ||c|| of the f64
product (the bound the two-stage proof uses), its keys hold the stage-1
contract against that product as the JAX package's keys do (Pallas
interpret), and a query alone gets the keys it gets in a batch of nine. The
same-call timing script of the candidate kernels (`scripts/cand_ab.py`)
measures on the card only and compares two saved runs anywhere.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")
tft = importlib.import_module("persian_rag_tpu_torch.ops.flat_topk")

N, Q, TILE, N_EASY = 700, 9, 256, 4  # 700 = 2 x 256 + 188: a short last tile
WIDTHS = [384, 512, 768, 77]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(d, seed):
    """Unit rows, their bf16 image and residues, their squared norms, and
    queries near rows (the stage-1 regime's margins)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((N, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = c[rng.integers(0, N, Q)] + 0.3 * rng.standard_normal(
        (Q, d)).astype(np.float32) / np.sqrt(d)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    hi = _t(c).bfloat16()
    lo = (_t(c) - hi.float()).bfloat16()
    csq = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return c, q, hi, lo, csq


def _ref_eps(c, q, csq, metric, d):
    """The f64 maximize-space scores and the proof's per-query bound."""
    ref = q.astype(np.float64) @ c.astype(np.float64).T
    err_f = 1.0
    if metric == "l2":
        ref = 2 * ref - csq[None, :]
        err_f = 2.0
    eps = (err_f * tft._bf16x2_matmul_eps(d) * np.linalg.norm(q, axis=1)
           * np.sqrt(csq.max()))
    return ref, eps


def _check_contract(slots, ref, eps):
    """(Q, J, n_easy+1) slots against ref (Q, N) f64 scores within eps (Q,):
    each extracted key decodes to its row and score, and every other row of
    a tile is at most the tile's bound."""
    dec = lambda k: tft._ikey_to_score(_t(k & ~tft._COL_MASK)).numpy()  # noqa
    keys, bound = slots[:, :, :N_EASY], slots[:, :, N_EASY]
    val = dec(keys).astype(np.float64)
    bump = val + np.abs(val) * 2.0 ** -11
    rows = (np.arange(keys.shape[1])[None, :, None] * TILE
            + (TILE - 1 - (keys & tft._COL_MASK)))
    present = keys != tft._INT_MIN
    assert (rows[present] < N).all()
    bval = dec(bound).astype(np.float64)
    bval = bval + np.abs(bval) * 2.0 ** -11
    for qi in range(ref.shape[0]):
        r = rows[qi][present[qi]]
        got = ref[qi, r]
        assert (got <= bump[qi][present[qi]] + eps[qi]).all()
        assert (got >= val[qi][present[qi]] - eps[qi]).all()
        rest = ref[qi].copy()
        rest[r] = -np.inf
        for j in range(slots.shape[1]):
            assert rest[j * TILE:(j + 1) * TILE].max() <= bval[qi, j] + eps[qi]


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("d", WIDTHS)
def test_chain_scores_within_the_proof_bound(d, metric):
    c, q, hi, lo, csq = _case(d, d)
    s = tft.bf16x2_chain_scores(_t(q), hi, lo)
    assert s.dtype == torch.float32 and s.shape == (Q, N)
    if metric == "l2":
        s = 2.0 * s - _t(csq)[None, :]
    ref, eps = _ref_eps(c, q, csq, metric, d)
    err = np.abs(s.numpy().astype(np.float64) - ref)
    assert (err <= eps[:, None]).all()
    # the matmul's plain version sums in another order: near, not equal
    plain = tft.flat_topk_candidates_plain(
        _t(q), hi, _t(csq) if metric == "l2" else None, TILE, N_EASY, lo)
    chain = tft.bf16x2_chain_candidates(
        _t(q), hi, lo, _t(csq) if metric == "l2" else None, TILE, N_EASY)
    assert (plain == chain).float().mean() > 0.95


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("d", WIDTHS)
def test_chain_keys_hold_the_contract_like_jax(d, metric):
    c, q, hi, lo, csq = _case(d, 1000 + d)
    cn = _t(csq) if metric == "l2" else None
    got = tft.bf16x2_chain_candidates(_t(q), hi, lo, cn, TILE, N_EASY)
    assert got.dtype == torch.int32 and got.shape == (Q, 3, N_EASY + 1)
    ref, eps = _ref_eps(c, q, csq, metric, d)
    _check_contract(got.numpy(), ref, eps)
    # the JAX package's bf16x2 stage 1 holds the same contract on these rows
    q_j = jnp.asarray(q)
    hi_j = jnp.asarray(c).astype(jnp.bfloat16)
    want_c, want_b, _ = jft.flat_topk_candidates(
        q_j, hi_j, metric=metric,
        corpus_sqnorm=jnp.asarray(csq) if metric == "l2" else None,
        tile_n=TILE, tile_q=8, n_easy=N_EASY, interpret=True,
        corpus_lo=(jnp.asarray(c) - hi_j.astype(jnp.float32)).astype(
            jnp.bfloat16),
        queries_lo=q_j - q_j.astype(jnp.bfloat16).astype(jnp.float32))
    want = np.concatenate(
        [np.asarray(want_c).reshape(Q, 3, N_EASY),
         np.asarray(want_b)[:, :, None]], axis=2)
    _check_contract(want, ref, eps)
    assert (got.numpy() == want).mean() > 0.95


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("d", WIDTHS)
def test_query_alone_keeps_its_keys(d, metric):
    """The chain's order is fixed by d alone: a query gets the same slots
    alone and in a batch of nine (the kernel's query block does not enter
    its arithmetic)."""
    c, q, hi, lo, csq = _case(d, 2000 + d)
    cn = _t(csq) if metric == "l2" else None
    batch = tft.bf16x2_chain_candidates(_t(q), hi, lo, cn, TILE, N_EASY)
    for qi in (0, 4, Q - 1):
        alone = tft.bf16x2_chain_candidates(_t(q[qi:qi + 1]), hi, lo, cn,
                                            TILE, N_EASY)
        assert torch.equal(alone[0], batch[qi])


def test_cand_ab_needs_a_card(capsys):
    """The same-call timing script of the candidate kernels measures on the
    card only: without CUDA it stops before building."""
    from persian_rag_tpu_torch.scripts import cand_ab

    assert cand_ab.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert cand_ab.CHIP_SMOKE.name == "chip_smoke.py"
    assert cand_ab.CHIP_SMOKE.exists()


def test_cand_ab_compares_saved_outputs(tmp_path, capsys):
    """`--compare` counts, by kernel, the outputs two saved runs share bit
    for bit, and sets each case's proof rate beside the other run's."""
    from persian_rag_tpu_torch.scripts import cand_ab

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"bf16 dot 64": "x", "bf16x2 l2 64": "y",
                             "maxonly int8 64": "z", "int8 dot 1": "w",
                             "proof_ok bf16x2 l2 64": 1.0,
                             "proof_ok bf16 dot 64": 0.5}))
    b.write_text(json.dumps({"bf16 dot 64": "x", "bf16x2 l2 64": "other",
                             "maxonly int8 64": "z",
                             "proof_ok bf16x2 l2 64": 1.0,
                             "proof_ok bf16 dot 64": 0.25}))
    assert cand_ab.main(["--compare", str(a), str(b)]) == 0
    lines = [(line.split(" ", 1)[0], json.loads(line.split(" ", 1)[1]))
             for line in capsys.readouterr().out.splitlines()]
    assert lines == [
        ("proof_ok", {"case": "bf16 dot 64", "a": 0.5, "b": 0.25,
                      "b_lower": True}),
        ("proof_ok", {"case": "bf16x2 l2 64", "a": 1.0, "b": 1.0,
                      "b_lower": False}),
        ("bits", {"kernel": "bf16", "outputs": 1, "bit_equal": 1}),
        ("bits", {"kernel": "bf16x2", "outputs": 1, "bit_equal": 0}),
        ("bits", {"kernel": "maxonly", "outputs": 1, "bit_equal": 1})]
