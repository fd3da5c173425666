"""The grouped / lane-sliced stage 1 (#3) past what a block holds of its
queries beside its key table, on the CPU.

On the card a #3 block keeps 16 x min(depth, group) x tile_n / group int32
keys in shared memory, and beside them its 16 queries and a 32-row chunk of
rows. Past what fits (d = 790 at tile 2,048 with group <= depth, 1,686 at
group 16 depth 2, 1,622 at depth 3) it stages the queries and the chunk in
even windows of K values, each chain carried across them k ascending from
+0, so the keys keep their bits at any d. `grouped_geometry` mirrors the
kernel's choice; the plain version the CPU takes is held to the JAX
package's grouped kernel (Pallas interpret) at d = 1,024.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (tile_n, group, depth): the widest window, then (windows, window) at d
# = 1,024 / 2,048 / 4,000
WINDOWS = {
    (2048, 16, 16): (790, {1024: (2, 512), 2048: (3, 684), 4000: (6, 668)}),
    (2048, 16, 2): (1686, {1024: (1, 1024), 2048: (2, 1024),
                           4000: (3, 1334)}),
    (2048, 16, 3): (1622, {1024: (1, 1024), 2048: (2, 1024),
                           4000: (3, 1334)}),
}


@pytest.mark.parametrize("d", [1024, 2048, 4000])
@pytest.mark.parametrize("config", list(WINDOWS), ids=["group<=depth",
                                                       "group16x2",
                                                       "group16x3"])
def test_grouped_geometry_windows(config, d):
    """Where the windows start and how wide they are: the whole even width
    up to the widest window beside the key table, past it the fewest even
    windows that fit, spread evenly; shared memory within a block's."""
    tile_n, group, depth = config
    widest, at = WINDOWS[config]
    geo = tft.grouped_geometry(64, 100_000, d, tile_n, group, depth)
    assert (geo.windows, geo.window) == at[d]
    assert geo.window % 2 == 0 and geo.window <= widest
    assert geo.window * geo.windows >= d > geo.window * (geo.windows - 1)
    assert geo.smem <= tft._SMEM_LIMIT
    assert geo.queries == 16 and geo.blocks == 4 * -(-100_000 // tile_n)
    whole = tft.grouped_geometry(64, 100_000, widest, tile_n, group, depth)
    past = tft.grouped_geometry(64, 100_000, widest + 1, tile_n, group,
                                depth)
    assert (whole.windows, whole.window) == (1, widest)
    assert past.windows == 2


def test_grouped_geometry_refuses_only_a_key_table_past_shared_memory():
    """No width is refused; a key table that alone leaves no room is."""
    assert tft.grouped_geometry(1, 10, 100_000, 2048, 1, 1).windows > 1
    with pytest.raises(ValueError, match="key table"):
        tft.grouped_geometry(1, 10, 64, 4096, 1, 1)
    with pytest.raises(ValueError, match="divide"):
        tft.grouped_geometry(1, 10, 64, 2048, 24, 2)


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
