"""The bf16 stage 1 (#1, `extract_candidates_bf16_cuda`: the two-stage
regime's stage 1 over a bf16 image) on the CPU.

The card's kernel (csrc/flat_topk_candidates_bf16.cu) scores each (query,
row) as ONE f32 chain from +0, k ascending, of bf16(q_k) c_k (for l2 then
2 s - ||c||^2 with one rounding), and selects a tile's top n_easy + 1 keys
from its 256-row parts' top n_easy + 1. `flat_topk.bf16_chain_scores`
mirrors that chain (a product of two bf16 values is exact in f32, so mul
then add is the kernel's fmaf) and `bf16_chain_candidates` its slots;
chip_smoke.py holds the kernel to the mirror bit for bit on the card. Here:

* the mirror's chain equals a float32 loop in the chain's order, and lies
  within `_bf16_matmul_eps(d)` ||q|| ||c|| of the f64 product (the bound
  the two-stage proof rests on);
* its slots keep the stage-1 contract (every key left behind is at most
  its tile's bound, up to the bound's rounding) as the JAX package's bf16
  stage 1 (`flat_topk_candidates`, Pallas interpret) does, and agree with
  its keys within one key quantum, with equal columns off near-ties: dot
  and l2, d odd, n not a multiple of the tile, n_easy 1 and 7;
* the (d, N) layout gives the (N, d) keys bit for bit, and a query alone
  the keys it has in a batch;
* the part-and-merge selection equals the whole tile's at Q = 1, 8, 9, 16,
  17, 33 and 65 (the kernel's query blocks of 8, 16, 32 and 64 and their
  edges);
* the wrapper raises on CPU tensors, before any build.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

PART = 256
_MASK = (1 << 11) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(rng, n, d):
    """Unit rows in bf16 (as f32 values); rows 1,000-1,063 copy rows 0-63
    (mass ties across and inside tiles) when n allows."""
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    if n >= 1064:
        c[1000:1064] = c[:64]
    return _t(c).bfloat16()


def _sqnorm(c16):
    c = c16.float()
    return (c * c).sum(dim=1)


def _keys(scores, tile_n):
    n = scores.shape[1]
    col = torch.arange(n, dtype=torch.int32) % tile_n
    return (tft._score_to_ikey(scores) & ~_MASK) | (tile_n - 1 - col)[None, :]


@pytest.mark.parametrize("d", [24, 77, 384])
def test_chain_is_the_ordered_f32_loop_within_the_proof_bound(d):
    rng = np.random.default_rng(d)
    c16 = _rows(rng, 1200, d)
    q = rng.standard_normal((5, d)).astype(np.float32)
    got = tft.bf16_chain_scores(_t(q), c16).numpy()
    qh = _t(q).bfloat16().float().numpy()
    c = c16.float().numpy()
    acc = np.zeros((5, 1200), np.float32)
    for k in range(d):
        acc = acc + qh[:, k, None] * c[:, k][None, :]
    np.testing.assert_array_equal(got, acc)
    exact = q.astype(np.float64) @ c.T.astype(np.float64)
    bound = (tft._bf16_matmul_eps(d) * np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(c, axis=1)[None, :])
    assert (np.abs(got - exact) <= bound).all()


def _check_contract(slots, ref, eps, tile_n, n_easy):
    """Every row of a tile that is not among its n_easy candidates scores
    at most the tile's bound (bumped for the key's truncated bits) + eps."""
    n_q, n_tiles, _ = slots.shape
    n = ref.shape[1]
    cand = slots[:, :, :n_easy]
    taken = np.zeros((n_q, n_tiles * tile_n), bool)
    for qi in range(n_q):
        for j in range(n_tiles):
            for key in cand[qi, j]:
                if key != tft._INT_MIN:
                    taken[qi, j * tile_n + tile_n - 1 - (key & _MASK)] = True
    bval = tft._ikey_to_score(_t(slots[:, :, n_easy] & ~_MASK)).numpy()
    bval = bval.astype(np.float64) + np.abs(bval) * 2.0 ** -11
    padded = np.full((n_q, n_tiles * tile_n), -np.inf)
    padded[:, :n] = ref
    for j in range(n_tiles):
        block = np.where(taken[:, j * tile_n:(j + 1) * tile_n], -np.inf,
                         padded[:, j * tile_n:(j + 1) * tile_n])
        assert (block.max(axis=1) <= bval[:, j] + eps).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("n, d, tile_n, n_easy", [
    (1800, 77, 512, 4),    # d odd, a short last tile
    (2100, 64, 1024, 1),   # n_easy 1
    (1500, 33, 256, 7),    # n_easy 7, d odd
])
def test_chain_candidates_keep_the_contract_like_jax(metric, n, d, tile_n,
                                                     n_easy):
    rng = np.random.default_rng(n + d + n_easy)
    c16 = _rows(rng, n, d)
    q = rng.standard_normal((9, d)).astype(np.float32)
    csq = _sqnorm(c16)
    cn = csq if metric == "l2" else None
    got = tft.bf16_chain_candidates(_t(q), c16, cn, tile_n, n_easy)
    want_c, want_b, tn = jft.flat_topk_candidates(
        jnp.asarray(q), jnp.asarray(c16.float().numpy()).astype(jnp.bfloat16),
        metric=metric, corpus_sqnorm=jnp.asarray(csq.numpy()) if cn is not None
        else None, tile_n=tile_n, tile_q=8, n_easy=n_easy, interpret=True)
    assert tn == tile_n and got.shape == (9, -(-n // tile_n), n_easy + 1)
    ref = q.astype(np.float64) @ c16.float().numpy().T.astype(np.float64)
    err_f = 1.0
    if metric == "l2":
        ref = 2 * ref - csq.numpy()[None, :]
        err_f = 2.0
    eps = (err_f * tft._bf16_matmul_eps(d) * np.linalg.norm(q, axis=1)
           * np.sqrt(float(csq.max())))
    _check_contract(got.numpy(), ref, eps, tile_n, n_easy)
    # the JAX kernel's keys, to one quantum (another summation order)
    got_c = got[:, :, :n_easy].reshape(9, -1).numpy()
    want_c = np.asarray(want_c)
    g_q, w_q = got_c.astype(np.int64) >> 11, want_c.astype(np.int64) >> 11
    assert (np.abs(g_q - w_q) <= 1).all()
    apart = (np.abs(np.diff(g_q, axis=1, prepend=g_q[:, :1] + 9)) > 2) & (
        np.abs(np.diff(g_q, axis=1, append=g_q[:, -1:] - 9)) > 2)
    same_col = (got_c & _MASK) == (want_c & _MASK)
    assert same_col[apart].all()
    # and the plain version (a library product, another order) as well
    plain = tft.flat_topk_candidates_plain(_t(q), c16, cn, tile_n, n_easy)
    p_q = plain.numpy().astype(np.int64) >> 11
    assert (np.abs(p_q - (got.numpy().astype(np.int64) >> 11)) <= 1).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_layouts_and_a_query_alone_give_the_same_keys(metric):
    rng = np.random.default_rng(8)
    n, d = 1300, 45
    c16 = _rows(rng, n, d)
    cn = _sqnorm(c16) if metric == "l2" else None
    q = _t(rng.standard_normal((6, d)).astype(np.float32))
    rows = tft.bf16_chain_candidates(q, c16, cn, 512, 4)
    cols = tft.bf16_chain_candidates(q, c16.t().contiguous(), cn, 512, 4,
                                     transposed=True)
    assert torch.equal(rows, cols)
    alone = tft.bf16_chain_candidates(q[3:4], c16, cn, 512, 4)
    assert torch.equal(alone[0], rows[3])


def _parts_then_merge(keys, n_q, n, tile_n, n_easy):
    """A tile's slots from its parts: each part's top n_easy + 1 keys, then
    the top n_easy + 1 of their union (the kernel's second launch)."""
    full = tft._INT_MIN * torch.ones((n_q, -(-n // tile_n) * tile_n),
                                     dtype=torch.int32)
    full[:, :n] = keys
    tiles = full.view(n_q, -1, tile_n // PART, PART)
    part_top = torch.topk(tiles, n_easy + 1, dim=3).values
    merged = part_top.reshape(n_q, tiles.shape[1], -1)
    return torch.topk(merged, n_easy + 1, dim=2).values


@pytest.mark.parametrize("n_q", [1, 8, 9, 16, 17, 33, 65])
def test_part_merge_equals_whole_tile_selection(n_q):
    """2,500 rows at tile 1,024: two full tiles and a short last one of 452
    rows (one full part and a short one); rows 1,000-1,063 tie rows 0-63."""
    rng = np.random.default_rng(50 + n_q)
    n, d, tile_n, n_easy = 2500, 40, 1024, 4
    c16 = _rows(rng, n, d)
    cn = _sqnorm(c16)
    q = _t(rng.standard_normal((n_q, d)).astype(np.float32))
    q[0] = c16[3].float()  # rows 3 and 1,003 tie exactly
    s = 2.0 * tft.bf16_chain_scores(q, c16) - cn[None, :]
    whole = tft.bf16_chain_candidates(q, c16, cn, tile_n, n_easy)
    assert whole.shape == (n_q, 3, n_easy + 1)
    assert torch.equal(whole, _parts_then_merge(_keys(s, tile_n), n_q, n,
                                                tile_n, n_easy))
    top = whole[0].reshape(-1)
    assert (top & ~_MASK).unique(return_counts=True)[1].max() >= 2


def test_bf16_kernel_needs_cuda_tensors():
    rng = np.random.default_rng(3)
    c16 = _rows(rng, 1200, 16)
    q = _t(rng.standard_normal((2, 16)).astype(np.float32))
    before = tft.extract_candidates_bf16_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tft.extract_candidates_bf16_cuda(q, c16, None, 1024, 4)
    assert tft.extract_candidates_bf16_cuda.launches == before
