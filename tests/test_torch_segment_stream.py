"""Modes fasti (#7) and fastg (#8) of the running top-k as their
register-stream kernel runs them, on the CPU.

The kernel walks each segment's 256-row tiles on the register stream and,
per query, skips a tile whose best key could not enter the query's list:
every insert would be a no-op (fasti) and every merge would return the
list itself (fastg, whose query then keeps its list where it is). The
plain versions the CPU takes skip the same (query, tile) pairs; here they
are held bit for bit to themselves without the skip, and to the JAX
package's running top-k (`flat_topk_pallas(interpret=True)`, mode "fast":
the lists all three fast modes return; JAX's own fasti / fastg write pad
rows into a list whose last tile holds fewer real rows than n_easy, which
tests/test_torch_flat_topk_modes.py shows beside the port's correction).
`segment_geometry` mirrors the kernel's launch: the query block by Q and
k, segments of whole tiles.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

SMS = 132  # the H100's SMs
QUANTUM = 2.0 ** -11  # one packed-key quantum, relative to the score


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [258, 1025, 4097])
@pytest.mark.parametrize("k", [1, 10, 70, 128])
def test_tile_skip_leaves_the_lists_unchanged(monkeypatch, k, n):
    """With mass ties (rows repeated at random), fasti's and fastg's lists
    with the per-query tile skip equal those without it bit for bit, the
    skip taken on most (query, tile) pairs once lists fill; and both equal
    JAX's running top-k (ids, order; scores within one key quantum)."""
    rng = np.random.default_rng(n + k)
    base = rng.standard_normal((n // 3 + 1, 24)).astype(np.float32)
    c = base[rng.integers(0, len(base), n)]  # many exact ties
    q = rng.standard_normal((5, 24)).astype(np.float32)
    want_s, want_i = (np.asarray(x) for x in jft.flat_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), k, tile_q=8, tile_n=256, mode="fast",
        interpret=True))
    skips = []
    orig = tft._tile_skips

    def counted(keys, run):
        out = orig(keys, run)
        skips.append(out.float().mean().item())
        return out

    monkeypatch.setattr(tft, "_tile_skips", counted)
    got = {m: tft.flat_topk_running(_t(q), _t(c), k, mode=m)
           for m in ("fasti", "fastg")}
    tiles = -(-n // 256)
    assert len(skips) == 2 * tiles
    if k < 128 and n > 1024:
        assert max(skips) > 0.5
    monkeypatch.setattr(tft, "_tile_skips",
                        lambda keys, run: torch.zeros(keys.shape[0],
                                                      dtype=torch.bool))
    for mode, (s, i) in got.items():
        s0, i0 = tft.flat_topk_running(_t(q), _t(c), k, mode=mode)
        assert torch.equal(s, s0) and torch.equal(i, i0), mode
        np.testing.assert_array_equal(i.numpy(), want_i)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=QUANTUM,
                                   atol=1e-6)


CASE_Q = [1, 8, 9, 16, 17, 33, 64, 512, 2048]


@pytest.mark.parametrize("mode", [0, 1], ids=["fasti", "fastg"])
@pytest.mark.parametrize("n_q", CASE_Q)
def test_segment_geometry(n_q, mode):
    """Every Q the earlier launch served, at k = 1 / 10 / 100 / 128, d = 24 /
    384 / 1,024 / 2,048 / 4,000 over f32, bf16 and int8 rows: the query
    block follows Q (64 above 32, 32 above 16, 8 up to 8, else 16), 32 in
    place of 64 where the whole width does not fit beside the key tile and
    the lists, smaller only where not one slab of queries fits; the block
    fits shared memory, its window covers d in whole slabs, and the
    segments are whole 256-row tiles at the fewest waves times tiles a
    block (`_segment_split`, the exact / fast kernels' split)."""
    n = 100_000
    for k in (1, 10, 100, 128):
        for d in (24, 384, 1024, 2048, 4000):
            for elem in (4, 2, 1):
                geo = tft.segment_geometry(n_q, n, d, k, elem, mode, SMS)
                kse = 64 // elem
                slabs = -(-d // kse)
                by_q = tft._stream_queries(n_q)
                whole64 = tft.segment_smem(d, elem, 64, k, mode)[1] == slabs
                assert geo.qb == by_q or (geo.qb < by_q and (
                    by_q == 64 and not whole64 or not tft.segment_smem(
                        d, elem, 2 * geo.qb, k, mode)[1]))
                assert (geo.smem, geo.slabs) == tft.segment_smem(
                    d, elem, geo.qb, k, mode)
                assert 0 < geo.smem <= tft._SMEM_LIMIT
                windows = -(-slabs // geo.slabs)
                assert -(-slabs // windows) == geo.slabs
                assert geo.rows_per_seg % 256 == 0
                assert geo.n_seg == -(-n // geo.rows_per_seg) <= 65_535
                assert geo.blocks == -(-n_q // geo.qb) * geo.n_seg
                assert (geo.per_sm, geo.rows_per_seg // 256,
                        geo.n_seg) == tft._segment_split(
                            -(-n_q // geo.qb), n, geo.qb, geo.smem, SMS)


def test_segment_geometry_at_the_tier_kernel_shape():
    """Q = 64 over 100k int8 rows of width 384: the whole width does not
    fit beside a 64-query key tile, so 32 queries, one block an SM, and
    the 132 blocks of 66 segments fill the card; fastg's three lists at k =
    128 still fit 32 queries."""
    for mode in (0, 1):
        for k in (10, 128):
            geo = tft.segment_geometry(64, 100_000, 384, k, 1, mode, SMS)
            assert (geo.qb, geo.slabs, geo.per_sm) == (32, 6, 1)
            assert (geo.n_seg, geo.blocks) == (66, 132)
    with pytest.raises(ValueError, match="k must be"):
        tft.segment_geometry(64, 100_000, 384, 129, 1, 0, SMS)
