"""Batch-1 decode matvec probe: does another weight-streaming schedule move
the decode matvec ceiling on this card?

The port's counterpart of ``scripts/bench_matvec_probe.py`` (the JAX
package's probe, same file name), asked with this card's kernels at the
Llama-3.2-1B decode matvec shapes (qkv/o 2048 x 2048, mlp 2048 x 8192 and
8192 x 2048, lm_head 2048 x 128,256, weights stored (K, N)). Arms per
shape, named as the JAX probe names them:

  w8a16           #14, the shipped kernel (``w8a16_cuda``)
  w8a16_splitk    #17, the shipped split-K kernel (``w8a16_splitk_cuda``)
  2d_bn{n}_bk{k}  #19 (``w8a16_2d``) at the JAX probe's three tiles under
                  its rule (N % bn == 0, K % bk == 0, bn * bk <= 2^21), then
                  at a small sweep of this card's tiles (bn in 64, 256, 1024
                  x bk in 256, 1024, N % bn == 0 and K % bk == 0)
  conv            torch.matmul(x_bf16, values.bfloat16() * scale.bfloat16()),
                  the dequantize inside the timed call (the JAX xla_conv)
  bf16_ref        torch.matmul on a bf16 copy of the dequantized weights made
                  outside the timed window; its bytes are 2 K N

The JAX probe's ``w8a16_4m`` arm (a 4 MB VMEM budget) is a TPU mechanic and
has no counterpart. Nothing in the package reads the result: a schedule is
adopted only by a later change, on a measured win.

Weights: seeded standard normal (K, N) through ``quantize_weight``.
Timing: a fresh seeded x for every call; ``reps`` calls queued back to back
behind a spin, timed with CUDA events, the best of 3 windows. The card's
50 MB L2 would hold the 4-17 MB layer weights, so every arm cycles over
copies of its weights that together exceed twice the L2: each call streams
them from device memory, as a decode step does. GB/s counts the int8
weight bytes K N (bf16_ref: 2 K N); the bound share is that rate over the
card's 3.35 TB/s.

Before timing, each arm's output at one x is held to the f64 product: the
kernels within the f32 summation bound (K + 2) 2^-24 sum_k |x w| scale
(K - 1 additions and the scale's product, each rounding once); the library
arms, which round the scale, the dequantized weights and the result to bf16
and may reduce in bf16, within 8 bf16 roundings (2^-5) of sum_k |x w| scale
more. An arm outside its bound raises. ``max_abs_err`` is the arm's largest
difference from its plain version (``w8a16_2d_plain`` for the tile arms,
``dequant_matmul_reference`` for the others).

    python -m persian_rag_tpu_torch.scripts.bench_matvec_probe [--reps 100] [--batch 1]

It runs on the card (``device=None``) and raises RuntimeError without CUDA;
``run(..., device="cpu")`` runs the plain versions with host-clock times,
for the tests.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from persian_rag_tpu_torch.core.device import (
    nvidia_smi_name_power,
    resolve_device,
)
from persian_rag_tpu_torch.ops import quant_matmul as qm

SHAPES = (
    ("qkv_o", 2048, 2048),
    ("mlp_up", 2048, 8192),
    ("mlp_down", 8192, 2048),
    ("lm_head", 2048, 128_256),
)
JAX_TILES = ((1024, 512), (2048, 256), (4096, 256))
SWEEP_TILES = tuple((bn, bk) for bn in (64, 256, 1024) for bk in (256, 1024))
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
L2_BYTES = 50 * 1024 * 1024
WINDOWS = 3
SEED = 0  # of the weights and the activations
# spin ahead of a window: ~100 us of host enqueue per queued call at the
# card's ~2 GHz clock, so the calls run back to back on the card
SPIN_CYCLES_PER_CALL = 200_000
LIBRARY_TOL = 2.0 ** -5  # 8 bf16 roundings of unit 2^-8


def jax_tiles(k: int, n: int) -> List[Tuple[int, int]]:
    """The JAX probe's 2-D tiles that its rule admits for (K, N)."""
    return [(bn, bk) for bn, bk in JAX_TILES
            if n % bn == 0 and k % bk == 0 and bn * bk <= 2 ** 21]


def tiles(k: int, n: int) -> List[Tuple[int, int]]:
    """Every #19 tile of the probe for (K, N): the JAX probe's, then the
    sweep's that divide the shape."""
    out = jax_tiles(k, n)
    out += [t for t in SWEEP_TILES
            if n % t[0] == 0 and k % t[1] == 0 and t not in out]
    return out


def _arms(k: int, n: int, scale: Optional[torch.Tensor]):
    """(name, kernel number, tile, fn(x, w)) per arm; w is one copy of the
    int8 values (bf16_ref: of the bf16 dequantized weights)."""
    arms = [
        ("w8a16", "#14", None, lambda x, w: qm._run("w8a16", x, w, scale)),
        ("w8a16_splitk", "#17", None,
         lambda x, w: qm._run("w8a16_splitk", x, w, scale)),
    ]
    for bn, bk in tiles(k, n):
        arms.append((f"2d_bn{bn}_bk{bk}", "#19", (bn, bk),
                     lambda x, w, bn=bn, bk=bk: qm.w8a16_2d(
                         x, w, scale, block_n=bn, block_k=bk)))
    arms.append(("conv", "library", None,
                 lambda x, w: torch.matmul(x, w.bfloat16() * scale.bfloat16())))
    arms.append(("bf16_ref", "library", None, torch.matmul))
    return arms


def arm_names(k: int, n: int) -> List[str]:
    return [name for name, *_ in _arms(k, n, None)]


def _copies(nbytes: int) -> int:
    return max(2, -(-2 * L2_BYTES // nbytes) + 1)


def _best_us(fn, xs: torch.Tensor, ws: torch.Tensor, dev) -> float:
    """Best over the windows of the mean time (us) of one call, each call
    with its own x and the next weight copy."""
    reps = xs.shape[1]
    fn(xs[0, 0], ws[0])  # warm-up
    best = math.inf
    for t in range(WINDOWS):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
            start.record()
            for i in range(reps):
                fn(xs[t, i], ws[i % len(ws)])
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for i in range(reps):
                fn(xs[t, i], ws[i % len(ws)])
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, 1e3 * ms / reps)
    return best


def run(shapes: Optional[Sequence[Tuple[str, int, int]]] = None,
        batch: int = 1, reps: int = 100, device=None) -> List[dict]:
    """One row per (shape, arm) of `shapes` (default SHAPES): its time per
    call (us), GB/s, share of the byte bound, and its error against the
    plain version. Raises RuntimeError without CUDA unless `device` names
    another device, and AssertionError when an arm's output leaves its
    bound."""
    dev = resolve_device(device)
    shapes = SHAPES if shapes is None else shapes
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={card} batch={batch} reps={reps}", flush=True)
    if dev.type == "cuda":
        print(nvidia_smi_name_power(), flush=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, k, n in shapes:
        values, scale = qm.quantize_weight(
            torch.randn((k, n), generator=g, device=dev))
        nbytes = k * n
        copies = _copies(nbytes) if dev.type == "cuda" else 1
        w8 = values.expand(copies, k, n).contiguous()
        w16 = (values.bfloat16() * scale.bfloat16()).expand(
            copies, k, n).contiguous()
        print(f"{name}: K={k} N={n}, {copies} weight copies cycled past the "
            f"L2 ({copies * nbytes / 2**20:.0f} MB int8)", flush=True)
        x = torch.randn((batch, k), generator=g, device=dev).bfloat16()
        exact = (x.double() @ values.double()) * scale.double()
        mass = (x.double().abs() @ values.double().abs()) * scale.double()
        xs = torch.randn((WINDOWS, reps, batch, k), generator=g,
                         device=dev).bfloat16()
        for arm, kernel, tile, fn in _arms(k, n, scale):
            lib = kernel == "library"
            ws = w16 if arm == "bf16_ref" else w8
            got = fn(x, ws[0]).float()
            tol = (LIBRARY_TOL * mass if lib else 0.0) + (
                (k + 2) * 2.0 ** -24 * mass)
            over = float(((got.double() - exact).abs() - tol).max())
            if not over <= 0 or not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"{name} {arm} B={batch}: {over:.3e} beyond its bound of "
                    "the f64 product")
            plain = (qm.w8a16_2d_plain(x, values, scale, tile[1]) if tile
                     else qm.dequant_matmul_reference(x, values, scale,
                                                      nt=False))
            eff = 2 * nbytes if arm == "bf16_ref" else nbytes
            us = _best_us(fn, xs, ws, dev)
            row = {
                "shape": name, "K": k, "N": n, "batch": batch, "arm": arm,
                "kernel": kernel,
                "block_n": tile[0] if tile else None,
                "block_k": tile[1] if tile else None,
                "us": us, "gb_per_s": eff / us * 1e-3,
                "bound_share": eff / HBM_BYTES_PER_S / (us * 1e-6),
                "max_abs_err": float((got - plain).abs().max()),
                "device": card,
            }
            rows.append(row)
            print(f"{name:9s} {arm:16s} {us:8.1f} us  {row['gb_per_s']:7.1f} "
                f"GB/s  {row['bound_share']:6.1%} of the byte bound",
                flush=True)
        del w8, w16, values, exact, mass
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)
    run(batch=args.batch, reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
