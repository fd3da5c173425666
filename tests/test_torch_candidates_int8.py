"""The int8 stage 1 (#4, `extract_candidates_int8_cuda`: the int8 tier's
row-scaled candidates) on the CPU.

The card's kernel (csrc/flat_topk_candidates_int8.cu) scores each (query,
row) as ONE f32 chain from +0, k ascending, of bf16(q_k) c_k, then one
multiply by the row's scale, and selects a tile's top n_easy + 1 keys from
its 256-row parts' top n_easy + 1. `flat_topk.int8_chain_scores` mirrors
that chain (a bf16 x int8 product is exact in f32, so mul then add is the
kernel's fmaf) and `int8_chain_candidates` its slots; chip_smoke.py holds
the kernel to the mirror bit for bit on the card. Here:

* the mirror's keys are within one key quantum of the JAX package's
  row-scaled candidates (`flat_topk_candidates(corpus_scale=...)`, Pallas
  interpret; another summation order), with equal ids off ties, and equal
  to a float32 loop in the chain's order;
* the part-and-merge selection (each 256-row part's top n_easy + 1, then
  the merge of a tile's parts) equals the whole tile's selection, with a
  short last tile, mass ties, and Q = 1, 8, 9, 16, 17 and 33 (the kernel's
  query blocks of 8, 16 and 32 and their edges).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

TILE, N_EASY, PART = 2048, 7, 256
_MASK = (1 << 11) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _int8_corpus(rng, n, d):
    """Unit rows quantized to int8 with per-row scales; rows 1,000-1,063
    copy rows 0-63 (mass ties across and inside tiles)."""
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[1000:1064] = c[:64]
    scales = np.maximum(np.abs(c).max(axis=1) / 127.0, 1e-12).astype(
        np.float32)
    values = np.clip(np.rint(c / scales[:, None]), -127, 127).astype(np.int8)
    return values, scales


def _parts_then_merge(slots_of_part, n_q, n, tile_n, n_easy):
    """A tile's slots from its parts: each part's top n_easy + 1 keys, then
    the top n_easy + 1 of their union (the kernel's second launch)."""
    keys = tft._INT_MIN * torch.ones((n_q, -(-n // tile_n) * tile_n),
                                     dtype=torch.int32)
    keys[:, :n] = slots_of_part
    tiles = keys.view(n_q, -1, tile_n // PART, PART)
    part_top = torch.topk(tiles, n_easy + 1, dim=3).values
    merged = part_top.reshape(n_q, tiles.shape[1], -1)
    return torch.topk(merged, n_easy + 1, dim=2).values


def _keys(scores, tile_n):
    n = scores.shape[1]
    col = torch.arange(n, dtype=torch.int32) % tile_n
    return (tft._score_to_ikey(scores) & ~_MASK) | (tile_n - 1 - col)[None, :]


@pytest.mark.parametrize("n_q", [1, 8, 9, 16, 17, 33])
def test_part_merge_equals_whole_tile_selection(n_q):
    """4,500 rows: two full tiles of 2,048 and a short last tile of 404
    (one full part and a short one)."""
    rng = np.random.default_rng(40 + n_q)
    n, d = 4500, 40
    values, scales = _int8_corpus(rng, n, d)
    q = _t(rng.standard_normal((n_q, d)).astype(np.float32))
    q[0] = _t(values[3].astype(np.float32))  # rows 3 and 1,003 tie exactly
    s = tft.int8_chain_scores(q, _t(values), _t(scales))
    whole = tft.int8_chain_candidates(q, _t(values), _t(scales), TILE,
                                      N_EASY)
    assert whole.shape == (n_q, 3, N_EASY + 1)
    merged = _parts_then_merge(_keys(s, TILE), n_q, n, TILE, N_EASY)
    assert torch.equal(whole, merged)
    # the tie survives in query 0's keys: two rows of one score
    top = whole[0].reshape(-1)
    assert (top & ~_MASK).unique(return_counts=True)[1].max() >= 2


@pytest.mark.parametrize("d", [24, 77, 384])
def test_chain_equals_the_ordered_plain_sum(d):
    """The mirror's chain, k ascending from +0, against a float64 sum of the
    same exact products rounded once: within d roundings, and equal to a
    float32 loop in the same order."""
    rng = np.random.default_rng(d)
    values, scales = _int8_corpus(rng, 1200, d)
    q = rng.standard_normal((5, d)).astype(np.float32)
    got = tft.int8_chain_scores(_t(q), _t(values), _t(scales)).numpy()
    qh = _t(q).bfloat16().float().numpy()
    acc = np.zeros((5, 1200), np.float32)
    for k in range(d):
        acc = acc + qh[:, k, None] * values[:, k].astype(np.float32)[None, :]
    np.testing.assert_array_equal(got, acc * scales[None, :])
    exact = (qh.astype(np.float64) @ values.T.astype(np.float64)) * scales
    bound = d * 2.0 ** -24 * (np.abs(qh) @ np.abs(values.T).astype(
        np.float64)) * scales + 2.0 ** -24 * np.abs(exact)
    assert (np.abs(got - exact) <= bound).all()


@pytest.mark.parametrize("n_q", [1, 8, 17])
def test_chain_candidates_match_jax_row_scaled(n_q):
    """Within one key quantum of the JAX kernel's keys, with equal ids
    wherever a key is more than two quanta from its neighbours."""
    rng = np.random.default_rng(70 + n_q)
    n, d = 4500, 48
    values, scales = _int8_corpus(rng, n, d)
    q = rng.standard_normal((n_q, d)).astype(np.float32)
    want, _, tn = jft.flat_topk_candidates(
        jnp.asarray(q), jnp.asarray(values), metric="dot",
        corpus_scale=jnp.asarray(scales), tile_n=TILE, tile_q=8,
        n_easy=N_EASY, interpret=True)
    assert tn == TILE
    got = tft.int8_chain_candidates(_t(q), _t(values), _t(scales), TILE,
                                    N_EASY)
    got_c = got[:, :, :N_EASY].reshape(n_q, -1).numpy()
    want_c = np.array(want)
    assert got_c.shape == want_c.shape
    # a key's score part counts quanta: the k-th key of a tile moves by at
    # most one when every score moves by less than one
    g_q, w_q = got_c.astype(np.int64) >> 11, want_c.astype(np.int64) >> 11
    assert (np.abs(g_q - w_q) <= 1).all()
    apart = (np.abs(np.diff(g_q, axis=1, prepend=g_q[:, :1] + 9)) > 2) & (
        np.abs(np.diff(g_q, axis=1, append=g_q[:, -1:] - 9)) > 2)
    assert apart.mean() > 0.5
    same_col = (got_c & _MASK) == (want_c & _MASK)
    assert same_col[apart].all()


def test_int8_kernel_needs_cuda_tensors():
    rng = np.random.default_rng(3)
    values, scales = _int8_corpus(rng, 1200, 16)
    q = _t(rng.standard_normal((2, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tft.extract_candidates_int8_cuda(q, _t(values), _t(scales), TILE,
                                         N_EASY)
