"""The grouped / lane-sliced stage 1 (#3) as its register-stream kernel
reduces a tile, on the CPU.

The kernel scores 256-row chunks of a tile on the register stream and, as
each chunk's chains finish, merges its keys into a per-(query, slot) table
in shared memory: row half 0, then 1; a thread's rows 32 columns apart,
those of one slot merged into one sorted carry first, then each carry down
its slot's levels. `_chunk_slots` below models that order and
`tft.grouped_chain_candidates` the kernel's keys (its chain, each tile's
table at once). Inputs come from a numpy seed: the chunk model is held
bit for bit to the plain candidates
(`flat_topk_candidates_plain(group=, depth=)`) on the same scores, and the
mirror to the JAX package's grouped kernel (Pallas interpret) within one
key quantum: the same bf16-rounded operands, f32 sums in two orders, so a
key's 21 score bits move by at most one step.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu_torch.ops import flat_topk as tft

jft = importlib.import_module("persian_rag_tpu.ops.flat_topk")

D, NE = 32, 4
# (tile_n, group, depth): group 16 at tile 1,024 (slots C = 64: a thread's
# rows two and two in a slot), the lane pick (16, 3) and (8, 2) at tile
# 2,048 (C = 128 / 256: every row its own slot)
CONFIGS = [(1024, 16, 2), (2048, 16, 3), (2048, 8, 2)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk_slots(s, tile_n, n_easy, group, depth):
    """The (Q, J, n_easy+1) slots of the grouped stage 1 (#3) from (Q, N)
    f32 scores, reduced as the kernel reduces them: each tile's 256-row
    chunks in order, and in a chunk the keys in the order its threads merge
    them (row half 0, then 1; a thread's rows i = 0..3 at columns chunk +
    128 half + lane + 32 i, rows that share a slot merged into one sorted
    carry first, then the carries down their slot's levels, lanes in turns
    of C = tile_n / group where C < 32). Keys in a tile are unique, so the
    order cannot change the table: equal to `_tile_slots(s, tile_n, n_easy,
    group, depth)` bit for bit."""
    n_q, n = s.shape
    dev = s.device
    n_tiles = -(-n // tile_n)
    slots, levels = tile_n // group, min(depth, group)
    p = (1 if 32 % slots == 0 else 2 if 64 % slots == 0
         else 3 if 96 % slots == 0 else 4)
    steps = {1: 1, 2: 2}.get(p, 4)
    span = min(slots, 32)
    col = torch.arange(n, device=dev, dtype=torch.int32) % tile_n
    key = (tft._score_to_ikey(s) & ~tft._COL_MASK) | (tile_n - 1 - col)[None, :]
    lanes = torch.arange(32, device=dev)
    out = torch.empty((n_q, n_tiles, n_easy + 1), dtype=torch.int32,
                      device=dev)
    for t in range(n_tiles):
        cols = min(tile_n, n - t * tile_n)
        tk = torch.full((n_q, -(-cols // tft._STREAM_ROWS) * tft._STREAM_ROWS),
                        tft._INT_MIN, dtype=torch.int32, device=dev)
        tk[:, :cols] = key[:, t * tile_n: t * tile_n + cols]
        table = torch.full((n_q, levels, slots), tft._INT_MIN, dtype=torch.int32,
                           device=dev)
        for chunk in range(0, cols, tft._STREAM_ROWS):
            for half in (0, 1):
                cb = chunk + 128 * half + lanes  # a thread's row 0
                k4 = tk[:, cb[:, None] + 32 * torch.arange(4, device=dev)]
                for i in range(steps):
                    if p == 1:
                        carry = k4
                    elif p == 2:
                        carry = k4[:, :, [i, i + 2]]
                    else:
                        carry = k4[:, :, [i]]
                    carry = torch.sort(carry, dim=2, descending=True).values
                    slot = (cb + 32 * i) % slots
                    for base in range(0, 32, span):
                        sl = slot[base: base + span]
                        x = carry[:, base: base + span].clone()  # (Q, L, W)
                        for e in range(levels):  # `slot_merge`
                            v = table[:, e, sl]
                            for j in range(x.shape[2]):
                                hi = torch.maximum(x[:, :, j], v)
                                v = torch.minimum(x[:, :, j], v)
                                x[:, :, j] = hi
                            table[:, e, sl] = x[:, :, 0]
                            x = torch.cat([x[:, :, 1:], v[:, :, None]], dim=2)
        flat = table.reshape(n_q, levels * slots)  # level-major, as in smem
        if flat.shape[1] < n_easy + 1:
            flat = torch.cat([flat, torch.full(
                (n_q, n_easy + 1 - flat.shape[1]), tft._INT_MIN,
                dtype=torch.int32, device=dev)], dim=1)
        ranks = torch.topk(flat, n_easy + 1, dim=1).values
        deep = table[:, levels - 1].max(dim=1).values
        if depth > group:
            deep = torch.full_like(deep, tft._INT_MIN)
        out[:, t, :n_easy] = ranks[:, :n_easy]
        out[:, t, n_easy] = torch.maximum(ranks[:, n_easy], deep)
    return out


def _jax_kw(group, depth):
    return (dict(group=group) if depth == 2
            else dict(lane_slots=group, lane_depth=depth))


def _steps(got, want):
    """Largest distance in 21-bit score steps between two key tensors that
    hold INT_MIN at the same places."""
    got, want = (np.asarray(x).astype(np.int64) for x in (got, want))
    empty = want == tft._INT_MIN
    assert np.array_equal(got == tft._INT_MIN, empty)
    return int(np.abs((got >> 11) - (want >> 11))[~empty].max(initial=0))


@pytest.mark.parametrize("n_q", [1, 9, 17, 65])
@pytest.mark.parametrize("config", CONFIGS, ids=["group16", "lane16x3",
                                                 "group8"])
def test_chunk_model_equals_plain_and_jax(config, n_q):
    """The chunked reduction equals the plain grouped candidates bit for bit
    on the same scores, over a last tile 1-3 rows past a 256-row chunk; the
    mirror of the kernel (its chain, then the chunked reduction) is within
    one key quantum of JAX's grouped kernel, keys and bounds."""
    tile_n, group, depth = config
    rng = np.random.default_rng(tile_n + group + depth + n_q)
    n = 2 * tile_n + 256 + 1 + n_q % 3  # the last tile 1-3 rows past a chunk
    c = rng.standard_normal((n, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = rng.standard_normal((n_q, D)).astype(np.float32)
    rows = _t(c).bfloat16()
    with tft.full_f32():  # the plain version's scores
        s = _t(q).bfloat16().float() @ rows.float().T
    model = _chunk_slots(s, tile_n, NE, group, depth)
    plain = tft.flat_topk_candidates_plain(_t(q), rows, None, tile_n, NE,
                                           group=group, depth=depth)
    assert model.shape == (n_q, 3, NE + 1)
    assert torch.equal(model, plain)
    # the kernel's chain, reduced in the kernel's order
    mirror = _chunk_slots(tft.bf16_chain_scores(_t(q), rows),
                                     tile_n, NE, group, depth)
    assert torch.equal(mirror, tft.grouped_chain_candidates(
        _t(q), rows, None, None, tile_n, NE, group, depth))
    keys, bounds, _ = jft.flat_topk_candidates(
        jnp.asarray(q), jnp.asarray(c).astype(jnp.bfloat16), tile_n=tile_n,
        tile_q=8, n_easy=NE, interpret=True, **_jax_kw(group, depth))
    assert _steps(mirror[:, :, :NE].reshape(n_q, -1), keys) <= 1
    assert _steps(mirror[:, :, NE], bounds) <= 1


@pytest.mark.parametrize("kind", ["bf16 l2", "int8"])
def test_chain_mirror_metrics_and_layout(kind):
    """The mirror over bf16 rows with the l2 map and over int8 rows with
    scales: within one key quantum of JAX's grouped kernel and of the plain
    candidates, and the (d, N) layout bit-equal to (N, d)."""
    tile_n, group, depth = 1024, 16, 2
    rng = np.random.default_rng(7)
    n, n_q = 2 * tile_n + 259, 9
    c = rng.standard_normal((n, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = rng.standard_normal((n_q, D)).astype(np.float32)
    if kind == "int8":
        c8 = rng.integers(-127, 128, (n, D)).astype(np.int8)
        scale = rng.uniform(0.5, 2.0, n).astype(np.float32) / 1000
        rows, cn, sc = _t(c8), None, _t(scale)
        jrows, jkw = jnp.asarray(c8), dict(corpus_scale=jnp.asarray(scale))
    else:
        csq = (c.astype(np.float64) ** 2).sum(1).astype(np.float32)
        rows, cn, sc = _t(c).bfloat16(), _t(csq), None
        jrows = jnp.asarray(c).astype(jnp.bfloat16)
        jkw = dict(metric="l2", corpus_sqnorm=jnp.asarray(csq))
    mirror = tft.grouped_chain_candidates(_t(q), rows, cn, sc, tile_n, NE,
                                          group, depth)
    flipped = tft.grouped_chain_candidates(_t(q), rows.t().contiguous(), cn,
                                           sc, tile_n, NE, group, depth,
                                           transposed=True)
    assert torch.equal(mirror, flipped)
    plain = tft.flat_topk_candidates_plain(_t(q), rows, cn, tile_n, NE,
                                           corpus_scale=sc, group=group,
                                           depth=depth)
    assert _steps(mirror, plain) <= 1
    keys, bounds, _ = jft.flat_topk_candidates(
        jnp.asarray(q), jrows, tile_n=tile_n, tile_q=8, n_easy=NE,
        interpret=True, group=group, **jkw)
    assert _steps(mirror[:, :, :NE].reshape(n_q, -1), keys) <= 1
    assert _steps(mirror[:, :, NE], bounds) <= 1


@pytest.mark.parametrize("tile_n,group,depth", [(256, 16, 2), (384, 16, 3),
                                                (640, 16, 5), (512, 1, 1),
                                                (1280, 16, 2)])
def test_chunk_model_every_slot_pattern(tile_n, group, depth):
    """Every way a thread's four rows fall in slots (C = tile_n / group:
    16 divides 32, all four in one slot, lanes in turns of 16; 24, rows 0
    and 3 together, lanes in turns of 24; 40, none together, lanes in turns
    of 32 whose rows of different steps share slots; 512, none, one level;
    80 with depth 2) reduces to the plain table bit for bit."""
    rng = np.random.default_rng(tile_n + depth)
    n = 3 * tile_n + 2
    s = _t(rng.standard_normal((5, n)).astype(np.float32))
    s[:, 7] = s[:, 8]  # an equal score: the column bits break the tie
    got = _chunk_slots(s, tile_n, NE, group, depth)
    assert torch.equal(got, tft._tile_slots(s, tile_n, NE, group, depth))
