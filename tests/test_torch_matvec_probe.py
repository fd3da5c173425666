"""Kernel #19 (the 2-D w8a16 tile of scripts/bench_matvec_probe.py) and the
port's matvec probe: the plain version `w8a16_2d_plain` against the JAX
package's `_w8a16_2d_call(..., interpret=True)`, whose kernel body is the
probe's inline kernel line for line (the script's own `w8a16_2d_call` is
local to its `main()`). Every product bf16 x int8 is exact in f32, so the
two differ only in the order of the f32 sum: rtol 1e-5, atol 1e-5 * max
scale * K, as in test_torch_quant_matmul.py."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from persian_rag_tpu.ops import quant_matmul as jq
from persian_rag_tpu_torch.ops import quant_matmul as tq
from persian_rag_tpu_torch.scripts import bench_matvec_probe as probe


def _weights(rng, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    values, scale = jq.quantize_weight(jnp.asarray(w))
    return np.asarray(values), np.asarray(scale)


def _close(got, want, scale, k):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(scale.max()) * k)


@pytest.mark.parametrize("k,n,bn,bk", [
    (512, 1024, 512, 128), (1024, 512, 256, 256), (256, 2048, 1024, 64)])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_plain_matches_pallas_interpret(rng, b, k, n, bn, bk):
    values, scale = _weights(rng, k, n)
    x = rng.standard_normal((b, k)).astype(np.float32)
    want = np.asarray(jq._w8a16_2d_call(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(values),
        jnp.asarray(scale), block_n=bn, block_k=bk, interpret=True))
    tx = torch.tensor(x).bfloat16()
    got = tq.w8a16_2d_plain(tx, torch.tensor(values), torch.tensor(scale), bk)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    _close(got.numpy(), want, scale, k)
    # the dispatcher takes the plain version on CPU tensors
    routed = tq.w8a16_2d(tx, torch.tensor(values), torch.tensor(scale),
                         block_n=bn, block_k=bk)
    assert torch.equal(routed, got)


def test_plain_one_tile_is_the_reference(rng):
    k, n = 384, 256
    values, scale = _weights(rng, k, n)
    x = torch.tensor(rng.standard_normal((5, k)).astype(np.float32))
    v, s = torch.tensor(values), torch.tensor(scale)
    assert torch.equal(tq.w8a16_2d_plain(x, v, s, k),
                       tq.dequant_matmul_reference(x, v, s, nt=False))


def _jax_rule(k, n):
    """The tile loop of scripts/bench_matvec_probe.py, as written there."""
    n_pad = ((n + 127) // 128) * 128
    return [f"2d_bn{bn2}_bk{bk2}"
            for bn2, bk2 in ((1024, 512), (2048, 256), (4096, 256))
            if n_pad % bn2 == 0 and k % bk2 == 0 and bn2 * bk2 <= 2**21]


@pytest.mark.parametrize("name,k,n,want", [
    ("qkv_o", 2048, 2048, ["2d_bn1024_bk512", "2d_bn2048_bk256"]),
    ("mlp_up", 2048, 8192,
     ["2d_bn1024_bk512", "2d_bn2048_bk256", "2d_bn4096_bk256"]),
    ("mlp_down", 8192, 2048, ["2d_bn1024_bk512", "2d_bn2048_bk256"]),
    ("lm_head", 2048, 128_256, []),
])
def test_arms_follow_the_jax_rule(name, k, n, want):
    assert (name, k, n) in probe.SHAPES
    jax_arms = [f"2d_bn{bn}_bk{bk}" for bn, bk in probe.jax_tiles(k, n)]
    assert jax_arms == _jax_rule(k, n) == want
    names = probe.arm_names(k, n)
    assert names[:2] == ["w8a16", "w8a16_splitk"]
    assert names[-2:] == ["conv", "bf16_ref"]
    assert names[2:2 + len(want)] == want
    sweep = probe.tiles(k, n)[len(want):]
    assert len(set(probe.tiles(k, n))) == len(probe.tiles(k, n))
    assert sweep and all(t in probe.SWEEP_TILES for t in sweep)
    for bn, bk in sweep:
        assert n % bn == 0 and k % bk == 0
    missing = [t for t in probe.SWEEP_TILES
               if n % t[0] == 0 and k % t[1] == 0 and t not in sweep]
    assert not missing


@pytest.mark.parametrize("name,k,n,bn,bk", [
    (name, k, n, bn, bk) for name, k, n in probe.SHAPES
    for bn, bk in probe.tiles(k, n)])
def test_tile2d_geometry_at_the_probe_tiles(name, k, n, bn, bk):
    """#19's launch at every probe shape and tile: 64-column strips times
    chunks of a K tile (a multiple of 16 dividing block_k, at most 1,024
    rows), cut only as far as two chunks per SM of the H100 need and never
    below a 64-row ring stage; a block streams the fewest consecutive
    chunks (at most 1,024 K rows) that leave at most two blocks per SM; one
    ticket per strip; a (rows, N) plane of partials per chunk. block_n is
    not an argument: tiles of equal block_k launch alike."""
    strips = n // 64
    for rows in (1, 8, 256):
        geo = tq.tile2d_geometry(rows, k, n, bk)
        chunks = k // geo.k_chunk
        split = bk // geo.k_chunk
        assert geo.k_chunk * split == bk
        assert geo.k_chunk % 16 == 0 and geo.k_chunk <= 1024
        assert geo.tickets == strips
        assert geo.scratch_floats == chunks * rows * n
        cuts = [s for s in range(1, bk // 16 + 1)
                if (bk // 16) % s == 0 and bk // s <= 1024]
        if split != cuts[0]:
            # the cut before it left fewer than two chunks per SM
            before = cuts[cuts.index(split) - 1]
            assert (k // bk) * strips * before < 264
            assert geo.k_chunk >= 64
        finer = [s for s in cuts if s > split]
        assert (chunks * strips >= 264 or not finer
                or bk // finer[0] < 64)
        assert 1 <= geo.run and geo.run * geo.k_chunk <= 1024
        assert geo.blocks == strips * -(-chunks // geo.run)
        # one chunk fewer a block would give more than two blocks per SM
        assert (geo.run == 1
                or strips * -(-chunks // (geo.run - 1)) > 264)
        assert geo.blocks <= 264 or (geo.run + 1) * geo.k_chunk > 1024
    if (name, bn, bk) == ("mlp_down", 2048, 256):
        # the kernels line: 32 strips x 8 runs of 4 tiles of 256 rows
        assert tq.tile2d_geometry(8, k, n, bk) == (256, 256, 4, 32, 524_288)


def test_run_on_cpu_returns_every_arm():
    """A row for every arm with finite times. `run` itself holds each arm to
    its bound of the f64 product (and raises outside it); on CPU tensors
    the kernel arms are their plain versions, so they equal plain."""
    before = tq.w8a16_2d_cuda.launches
    rows = probe.run(shapes=[("tiny", 256, 1024)], batch=2, reps=2,
                     device="cpu")
    assert [r["arm"] for r in rows] == probe.arm_names(256, 1024)
    assert {r["arm"] for r in rows} >= {"2d_bn64_bk256", "2d_bn1024_bk256"}
    for r in rows:
        assert r["device"] == "cpu" and r["batch"] == 2
        assert math.isfinite(r["us"]) and r["us"] > 0
        assert math.isfinite(r["gb_per_s"]) and r["gb_per_s"] > 0
        assert (r["kernel"] == "#19") == r["arm"].startswith("2d_")
        assert math.isfinite(r["max_abs_err"])
        if r["kernel"] != "library":
            assert r["max_abs_err"] == 0.0
    # CPU tensors never reach the CUDA wrapper
    assert tq.w8a16_2d_cuda.launches == before


def test_run_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run(shapes=[("tiny", 256, 1024)], reps=1)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _i8(*shape):
    return torch.zeros(shape, dtype=torch.int8)


def _ones(n):
    return torch.ones(1, n)


# (x, values, scale, block_n, block_k), built when the case runs
@pytest.mark.parametrize("case,args,match", [
    ("cpu tensors", lambda: (_bf16(2, 256), _i8(256, 512), _ones(512), 256,
                             128), "CUDA"),
    ("no rows", lambda: (_bf16(0, 256), _i8(256, 512), _ones(512), 256, 128),
     "rows"),
    ("257 rows", lambda: (_bf16(257, 256), _i8(256, 512), _ones(512), 256,
                          128), "rows"),
    ("block_n not a multiple of 64", lambda: (_bf16(1, 256), _i8(256, 192),
                                              _ones(192), 96, 128),
     "multiple of 64"),
    ("block_n over 4096", lambda: (_bf16(1, 256), _i8(256, 8192),
                                   _ones(8192), 8192, 128), "multiple of 64"),
    ("block_n not dividing N", lambda: (_bf16(1, 256), _i8(256, 640),
                                        _ones(640), 256, 128), "divide N"),
    ("block_k not a multiple of 16", lambda: (_bf16(1, 48), _i8(48, 128),
                                              _ones(128), 64, 24),
     "multiple of 16"),
    ("block_k not dividing K", lambda: (_bf16(1, 256), _i8(256, 128),
                                        _ones(128), 64, 96), "dividing K"),
    ("too many K tiles", lambda: (
        _bf16(1, 16 * 65536), torch.empty((16 * 65536, 64), dtype=torch.int8),
        _ones(64), 64, 16), "65,535"),
    ("x not bf16", lambda: (torch.zeros(1, 256), _i8(256, 128), _ones(128),
                            64, 128), "bfloat16"),
    ("x not contiguous", lambda: (_bf16(256, 2).T, _i8(256, 128), _ones(128),
                                  64, 128), "contiguous"),
    ("x not 16-byte aligned", lambda: (_bf16(1, 257)[:, 1:], _i8(256, 128),
                                       _ones(128), 64, 128), "aligned"),
    ("scale of another width", lambda: (_bf16(1, 256), _i8(256, 128),
                                        _ones(64), 64, 128), "scale"),
])
def test_cuda_wrapper_limits(case, args, match):
    """`w8a16_2d_cuda` refuses what `prt_w8a16_tile2d` does not take, and
    CPU tensors, with a ValueError naming the limit; nothing launches."""
    before = tq.w8a16_2d_cuda.launches
    with pytest.raises(ValueError, match=match):
        tq.w8a16_2d_cuda(*args())
    assert tq.w8a16_2d_cuda.launches == before


def test_dispatch_checks_limits_and_devices():
    x, v, s = _bf16(1, 256), _i8(256, 128), torch.ones(1, 128)
    with pytest.raises(ValueError, match="divide N"):
        tq.w8a16_2d(x, v, s, block_n=256, block_k=128)
    with pytest.raises(ValueError, match="K="):
        tq.w8a16_2d(_bf16(1, 128), v, s, block_n=64, block_k=128)
    with pytest.raises(ValueError, match="one device"):
        tq.w8a16_2d(x, torch.zeros((256, 128), dtype=torch.int8,
                                   device="meta"), s, block_n=64,
                    block_k=128)
    assert "w8a16_2d" not in tq.KERNELS and "w8a16_2d" not in tq.PLAIN
