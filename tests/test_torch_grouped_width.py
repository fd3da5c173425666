"""The grouped / lane-sliced stage 1 (#3) past what a block holds of its
queries beside its ring and key table, on the CPU.

On the card a #3 block keeps one (query block, tile): QB x min(depth,
group) x tile_n / group int32 keys in shared memory, and beside them the
register stream's ring and its queries k-major, f32, in whole 64-byte
slabs of a row. Past what fits it stages the queries a window of slabs at
a time, each chain carried across them k ascending from +0, so the keys
keep their bits at any d. `grouped_geometry` mirrors the kernel's choice
of query block and window; the plain version the CPU takes is held to the
JAX package's grouped kernel (Pallas interpret) at d = 1,024.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

SMS = 132  # the H100's SMs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (tile_n, group, depth) over 100k bf16 rows at Q = 64: 16 queries a block
# (49 tiles: 32 would leave SMs empty); the widest window in K values, then
# (windows, window) at d = 1,024 / 2,048 / 4,000
WINDOWS = {
    (2048, 16, 16): (736, {1024: (2, 512), 2048: (3, 704), 4000: (6, 672)}),
    (2048, 16, 2): (2176, {1024: (1, 1024), 2048: (1, 2048),
                           4000: (2, 2016)}),
    (2048, 16, 3): (2080, {1024: (1, 1024), 2048: (1, 2048),
                           4000: (2, 2016)}),
}


@pytest.mark.parametrize("d", [1024, 2048, 4000])
@pytest.mark.parametrize("config", list(WINDOWS), ids=["group<=depth",
                                                       "group16x2",
                                                       "group16x3"])
def test_grouped_geometry_windows(config, d):
    """Where the windows start and how wide they are: the whole width in
    whole slabs of 32 bf16 values up to the widest window beside the ring
    and the key table, past it the fewest windows of whole slabs that fit,
    spread evenly; shared memory within a block's."""
    tile_n, group, depth = config
    widest, at = WINDOWS[config]
    geo = tft.grouped_geometry(64, 100_000, d, tile_n, group, depth, 2, SMS)
    assert (geo.windows, geo.window) == at[d]
    assert geo.window % 32 == 0 and geo.window <= widest
    assert geo.window * geo.windows >= d > geo.window * (geo.windows - 1)
    assert geo.smem <= tft._SMEM_LIMIT
    assert geo.queries == 16 and geo.blocks == 4 * -(-100_000 // tile_n)
    assert (geo.smem, geo.window // 32) == tft.grouped_smem(
        d, 2, 16, tile_n, group, depth)
    whole = tft.grouped_geometry(64, 100_000, widest, tile_n, group, depth,
                                 2, SMS)
    past = tft.grouped_geometry(64, 100_000, widest + 1, tile_n, group,
                                depth, 2, SMS)
    assert (whole.windows, whole.window) == (1, widest)
    assert past.windows == 2


# (Q, N, tile_n, (group, depth), bytes a row value) -> queries a block
QUERY_BLOCKS = [
    (1, 100_000, 1024, (16, 2), 2, 8),
    (16, 100_000, 1024, (16, 2), 2, 8),      # 98 tiles: 8 fills the card
    (16, 1_000_000, 1024, (16, 2), 2, 16),
    (64, 100_000, 1024, (16, 2), 2, 32),     # 98 tiles: 32, 196 blocks
    (64, 1_000_000, 1024, (16, 2), 2, 32),   # 32 at most: two an SM
    (64, 100_000, 2048, (16, 3), 1, 16),     # 49 tiles
    (512, 100_000, 1024, (16, 2), 2, 32),
    (2048, 1_000_000, 2048, (16, 3), 2, 16),  # the lane pick: two an SM
    (2048, 1_000_000, 2048, (8, 2), 1, 16),
    (2048, 100_000, 256, (16, 2), 2, 32),
]


@pytest.mark.parametrize("n_q,n,tile_n,gd,elem,qb", QUERY_BLOCKS)
def test_grouped_geometry_picks_the_query_block(n_q, n, tile_n, gd, elem,
                                                qb):
    """The query block follows Q as the other register streams' does, up
    to 32 queries; 16 where 32 queries' whole width and key table do not
    let two blocks share an SM (the lane pick's 48 KB table); halved while
    the grid holds fewer blocks than the card's SMs (one block a (query
    block, tile))."""
    group, depth = gd
    geo = tft.grouped_geometry(n_q, n, 384, tile_n, group, depth, elem, SMS)
    n_tiles = -(-n // tile_n)
    assert geo.queries == qb
    assert geo.blocks == -(-n_q // qb) * n_tiles
    assert geo.windows == 1 and geo.smem <= tft._SMEM_LIMIT
    assert geo.blocks >= SMS or qb == 8
    if qb == 32:  # two blocks an SM
        assert 2 * (geo.smem + tft._BLOCK_SMEM_RESERVED) <= tft._SM_SMEM


def test_grouped_geometry_refuses_only_a_key_table_past_shared_memory():
    """No width is refused; a key table that alone leaves no room for 8
    queries' slab is."""
    assert tft.grouped_geometry(1, 10, 100_000, 2048, 1, 1, 2,
                                SMS).windows > 1
    with pytest.raises(ValueError, match="key table"):
        tft.grouped_geometry(1, 10, 64, 8192, 1, 1, 2, SMS)
    with pytest.raises(ValueError, match="divide"):
        tft.grouped_geometry(1, 10, 64, 2048, 24, 2, 2, SMS)


N, D, Q, NE = 1600, 1024, 8, 4
CONFIGS = [(512, dict(group=16)), (1024, dict(lane_slots=8, lane_depth=3))]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["bf16 dot", "bf16 l2", "int8"])
@pytest.mark.parametrize("tn,kw", CONFIGS, ids=["group16", "lane8x3"])
def test_grouped_plain_at_width_matches_jax(tn, kw, kind):
    """The grouped plain candidates at d = 1,024 against JAX's grouped
    kernel (Pallas interpret), bf16 and scaled int8 rows: keys and bounds
    equal in more than 98% of slots (the same bf16-rounded operands, f32
    sums in two orders: a key moves by at most one 21-bit quantum), and
    each tile's bound covers every key it did not extract."""
    rng = np.random.default_rng(41)
    q = _unit(rng, Q, D)
    metric = "l2" if kind == "bf16 l2" else "dot"
    if kind == "int8":
        corpus = rng.integers(-127, 128, (N, D)).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, N).astype(np.float32) / 1000
        rows, jrows = _t(corpus), jnp.asarray(corpus)
        s = (_t(q).bfloat16().float() @ _t(corpus).float().T) * _t(scale)
        extra, jextra = dict(corpus_scale=_t(scale)), dict(
            corpus_scale=jnp.asarray(scale))
    else:
        corpus = _unit(rng, N, D)
        csq = (corpus.astype(np.float64) ** 2).sum(1).astype(np.float32)
        rows, jrows = _t(corpus).bfloat16(), jnp.asarray(corpus).astype(
            jnp.bfloat16)
        s = _t(q).bfloat16().float() @ rows.float().T
        extra = dict(metric=metric,
                     corpus_sqnorm=_t(csq) if metric == "l2" else None)
        jextra = dict(metric=metric, corpus_sqnorm=jnp.asarray(csq)
                      if metric == "l2" else None)
        if metric == "l2":
            s = 2.0 * s - _t(csq)[None, :]
    keys, bounds, got_tn = tft.flat_topk_candidates(
        _t(q), rows, tile_n=tn, n_easy=NE, **extra, **kw)
    want_k, want_b, _ = jft.flat_topk_candidates(
        jnp.asarray(q), jrows, tile_n=tn, tile_q=8, n_easy=NE,
        interpret=True, **jextra, **kw)
    keys, bounds = keys.numpy(), bounds.numpy()
    assert got_tn == tn and keys.shape == np.asarray(want_k).shape
    assert (keys == np.asarray(want_k)).mean() > 0.98
    assert (bounds == np.asarray(want_b)).mean() > 0.98
    col = torch.arange(N) % tn
    packed = ((tft._score_to_ikey(s) & ~tft._COL_MASK) | (tn - 1 - col)
              ).numpy().astype(np.int64)
    for qi in range(Q):
        for j in range(-(-N // tn)):
            taken = set(keys[qi, j * NE:(j + 1) * NE].tolist())
            rest = [p for p in packed[qi, j * tn:(j + 1) * tn].tolist()
                    if p not in taken]
            assert not rest or max(rest) <= int(bounds[qi, j]), (qi, j)
