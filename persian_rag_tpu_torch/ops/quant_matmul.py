"""Quantized weight-streaming matmuls for decode serving.

The counterpart of ``persian_rag_tpu.ops.quant_matmul``: weights are stored
with a per-output-channel f32 scale, and

    w8a16: out = (x_bf16 . w_int8, accumulated in f32) * scale        -> f32
    w4a16: out = (x_bf16 . w_int4, accumulated in f32) * scale        -> f32
    w8a8:  out = f32(q(x)_int8 . w_int8, accumulated in int32) * scale * x_scale

An int8 or int4 value is exact in bf16 and a bf16 x int8 product is exact in
f32, so the bf16-activation results are defined up to the order of the f32
sum; the w8a8 sum is exact.

Layouts:

* ``w8a16_matmul``    -- w stored (K, N), scale (1, N): every int8 Dense.
* ``w8a16_matmul_nt`` -- w stored (N, K), scale (N, 1): the tied lm_head
  reads the embedding's own table, so quantized serving keeps no
  transposed copy of the vocabulary matrix.
* ``w4a16_matmul``    -- int4 values in [-8, 7] packed two to a byte, (K/2,
  N) int8: row i of the (K, N) matrix in the LOW nibble of packed row i,
  row i + K/2 in the HIGH nibble (``quantize_weight_int4``).
* ``w8a8_matmul``     -- w stored (K, N); each activation row quantized to
  int8 with its own scale, outside the kernel.

Routing, as in the JAX package, so that each shape reaches the same kernel:

* w8a16: more than ``_MAX_KERNEL_ROWS`` flattened rows (prefill) or an
  output width that is not a multiple of 128 -> ``dequant_matmul_reference``,
  the convert-and-matmul route (a plain f32 library product: the JAX package
  computes that route outside any kernel too); K >= ``W8A16_SPLIT_K`` with
  N % 1024 == 0 and K % 256 == 0 -> the split-K kernel (``_w8a16_2d_kernel``
  there, ``prt_w8a16_splitk`` here); else ``_w8a16_kernel`` /
  ``prt_w8a16``. Both CUDA entries run one body, one launch over a strip x
  K-chunk grid at ``w8a16_splitk_geometry`` (``w8a16_splitk_chunked_plain``
  sums in its chunk order), each under a kernel symbol of its own;
  the nt entry goes to ``_w8a16_nt_kernel`` / ``prt_w8a16_nt`` (on the
  tensor cores, ``w8a16_nt_geometry``).
* w4a16: more than ``_MAX_KERNEL_ROWS`` rows or N % 128 != 0 ->
  ``dequant_matmul_int4_reference``; every other shape, the K = 8192 down
  projection included, -> ``_w4a16_kernel`` / ``prt_w4a16`` (a strip x
  K-chunk grid, ``w4a16_geometry``; ``w4a16_chunked_plain`` sums in its
  chunk order).
* w8a8: more than ``_MAX_KERNEL_ROWS`` rows -> ``dequant_matmul_reference``
  (the w8a16 route: no activation quantization there, as in the JAX
  package); N % 128 != 0 raises ValueError; else ``_w8a8_kernel`` /
  ``prt_w8a8`` (on the int8 tensor cores, a strip x K-chunk grid at
  ``w8a8_geometry``; int32 partials, so any order of them gives the same
  bits).

The (K, N) kernels take every K their JAX kernels take (the wrappers pad x
with zeros, ``_pad_x``); #15 (``prt_w8a16_nt``) needs K % 16 == 0.

On CUDA tensors the kernel route launches the hand-written kernels of
``csrc/quant_matmul.cu`` or raises; on CPU tensors it runs the plain
version (``PLAIN``); any other device raises. ``KERNELS`` and ``PLAIN`` are
looked up at call time, keyed by kernel name.

Outside the routing: ``w8a16_2d`` computes w8a16 on a caller's (block_n,
block_k) tile grid, the schedule of the inline kernel of
``scripts/bench_matvec_probe.py`` (``w8a16_2d_call``): f32 partials per K
tile, summed in tile order, the scale last (``prt_w8a16_tile2d``; plain
version ``w8a16_2d_plain``). Only the matvec probe
(``persian_rag_tpu_torch.scripts.bench_matvec_probe``) calls it, so it is
in neither ``KERNELS`` nor ``PLAIN``; ``kernel_route`` never picks it.

Left behind: ``pick_block_n``, the 16- and 32-row batch padding, the 2 MB
block budget, the probe's 4 MB-budget arm (``w8a16_4m``:
``pick_block_n(..., vmem_budget=4 MB)``) and the ``PRAG_W8A16_SPLIT_K``
environment switch are TPU mechanics.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from persian_rag_tpu_torch.ops.flat_topk import full_f32

__all__ = [
    "quantize_weight",
    "quantize_weight_int4",
    "w8a16_matmul",
    "w8a16_matmul_nt",
    "w8a8_matmul",
    "w4a16_matmul",
    "unpack_int4",
    "quantize_rows",
    "dequant_matmul_reference",
    "dequant_matmul_int4_reference",
    "w4a16_geometry",
    "w4a16_chunked_plain",
    "w8a16_splitk_geometry",
    "w8a16_splitk_chunked_plain",
    "w8a16_nt_geometry",
    "w8a8_geometry",
    "w8a16_2d",
    "w8a16_2d_plain",
]

# Above this many flattened rows the product is compute-bound and goes to
# the library route (prefill regime).
_MAX_KERNEL_ROWS = 256
# K from which the (K, N) product is cut into chunks across blocks
# (`w8a16_splitk_geometry`).
W8A16_SPLIT_K = 8192

def quantize_weight(
    w: torch.Tensor, axis: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization.

    ``axis`` is the REDUCTION axis of the matmul; the scale is per element
    of the other axis. For a (K, N) kernel pass axis=0 -> scale (1, N); for
    a (V, H) embedding table pass axis=1 -> scale (V, 1)."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    values = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return values, scale


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int4 of a (K, N) kernel, K-half nibble
    packing: q = clip(round(w / scale), -7, 7) with scale = max(amax,
    1e-8) / 7 (1, N); packed (K/2, N) int8 holds row i in the LOW nibble and
    row i + K/2 in the HIGH nibble."""
    w = w.float()
    k = w.shape[0]
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int32)
    lo, hi = q[: k // 2] & 0xF, q[k // 2:] & 0xF
    # (lo | hi << 4) is 0..255: wrap it to the int8 bit pattern
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 sign-extended nibbles of packed int8 bytes."""
    w32 = packed.to(torch.int32)
    return (w32 << 28) >> 28, (w32 << 24) >> 28


def dequant_matmul_int4_reference(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """The plain w4a16 version, and the route of shapes #18 does not take:
    x rounded to bf16, the nibbles (exact in f32) unpacked into the (K, N)
    matrix, one f32 matmul (TF32 off), the per-channel scale on the
    accumulator."""
    lo, hi = unpack_int4(packed)
    w = torch.cat([lo, hi], dim=0).float()
    with full_f32():
        acc = x.bfloat16().float() @ w
    return acc * scale


def _w8a8_plain(x_q, values, scale):
    """f32(x_q @ values, exact) * scale, the `_w8a8_kernel` contract. The
    int32 sum is at most 127^2 K in magnitude, so an f64 product (53-bit
    significand) computes it exactly on either device before the cast."""
    acc = (x_q.double() @ values.double()).to(torch.int32)
    return acc.float() * scale


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of activations (the JAX w8a8 wrapper's):
    x_scale = max(amax, 1e-8) / 127 (B, 1), x_q = clip(round(x /
    x_scale), -127, 127), rounding half to even."""
    xf = x2.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    x_scale = torch.clamp(amax, min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def dequant_matmul_reference(
    x: torch.Tensor,
    values: torch.Tensor,
    scale: torch.Tensor,
    nt: Optional[bool] = None,
) -> torch.Tensor:
    """The plain version, and the route of shapes the kernels do not take:
    x rounded to bf16, both operands widened to f32 (exact), one f32
    matmul (TF32 off), the per-channel scale on the accumulator. values
    (K, N), or (N, K) with nt=True (inferred from the shapes when
    unambiguous; pass nt for square matrices)."""
    if nt is None:
        if values.shape[0] == values.shape[1]:
            raise ValueError("square quantized matrix: pass nt= explicitly")
        nt = values.shape[0] != x.shape[-1]
    xf = x.bfloat16().float()
    w = values.float()
    with full_f32():
        acc = xf @ (w.T if nt else w)
    return acc * (scale.reshape(1, -1) if nt else scale)


def _w8a16_plain(x2, values, scale):
    return dequant_matmul_reference(x2, values, scale, nt=False)


def _w8a16_nt_plain(x2, values, scale):
    return dequant_matmul_reference(x2, values, scale, nt=True)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/quant_matmul.cu).
# ---------------------------------------------------------------------------


def _check_cuda(x2, values, scale, n: int, k: int, n_multiple: int,
                x_dtype=torch.bfloat16, pads_x: bool = True):
    """What the C entries need of their inputs. These checks only mirror
    each C entry's own limits (`n_multiple`: 64-column strips, any N for
    nt), so that a direct caller of a wrapper gets a ValueError naming the
    limit instead of the entry's cudaErrorInvalidValue. Any K passes: the
    (K, N) kernels never read a weight row past K, and their wrappers
    (`pads_x`) hand them x through `_pad_x`, which also copies a row that
    is not 16-byte aligned. Which shapes reach a kernel is decided by
    `kernel_route` alone (N % 128, the JAX package's gate). The device is
    checked last, so that every other limit can be shown on CPU tensors."""
    dev = x2.device
    for name, t, dtype in (("x", x2, x_dtype),
                           ("values", values, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and not (pads_x and t is x2):
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = x2.shape[0]
    if x2.dim() != 2 or x2.shape[1] != k or not 1 <= rows <= _MAX_KERNEL_ROWS:
        raise ValueError(
            f"x must be (1..{_MAX_KERNEL_ROWS}, {k}), got {tuple(x2.shape)}")
    if n % n_multiple:
        raise ValueError(f"N={n} must be a multiple of {n_multiple}")
    if scale.numel() != n:
        raise ValueError(f"scale must hold {n} values, got {scale.numel()}")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")


def _launch(fn_name: str, dev: torch.device, *args) -> None:
    """Call the library's `fn_name`(*args, stream) on PyTorch's current
    stream of `dev`; raises when the launch is refused."""
    from persian_rag_tpu_torch.ops import _build

    lib = _build.load()
    # a decode step makes over a hundred of these calls: switch the
    # current device only when it is another card's
    switch = (torch.cuda.device(dev)
              if torch.cuda.current_device() != dev.index
              else contextlib.nullcontext())
    with switch:
        err = getattr(lib, fn_name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"{fn_name} launch")


def _out(x2, n: int) -> torch.Tensor:
    return torch.empty((x2.shape[0], n), dtype=torch.float32, device=x2.device)


def _pad_x(x2, halves: bool = False) -> torch.Tensor:
    """x (B, K) as the (K, N) kernels read it (`x_layout` in
    csrc/quant_matmul.cu): each row padded with zeros to a multiple of 16
    values, or with `halves` (int4) each half of it, x[:, :K/2] and
    x[:, K/2:], so that a 16-byte load never passes a row, 16-byte
    aligned. A (B, K) copy when K or the alignment needs it, never one of
    the weights; a zero adds nothing to any sum."""
    rows, k = x2.shape
    half = k // 2 if halves else k
    if half % 16 == 0:
        return x2 if x2.data_ptr() % 16 == 0 else x2.clone()
    pad = -half % 16
    parts = x2.split(half, dim=1) if halves else (x2,)
    return torch.cat([torch.nn.functional.pad(p, (0, pad)) for p in parts],
                     dim=1)


def w8a16_cuda(x2, values, scale):
    """CUDA kernel for `_w8a16_kernel`'s contract: x (B, K) bf16, values
    (K, N) int8, scale (1, N) f32 -> (B, N) f32. One launch over 64-column
    strips times chunks of K rows (`w8a16_splitk_geometry`, a function of
    (K, N) alone), #17's body under a kernel symbol of its own; the last
    block of each strip sums its chunks' partials in chunk order and
    scales. Assumes the launches that share a stream's scratch run in
    stream order (`_tile2d_scratch`). `launches` counts."""
    k, n = values.shape
    _check_cuda(x2, values, scale, n, k, 64)
    out = _launch_splitk("prt_w8a16", x2, values, scale, k, n,
                         w8a16_splitk_geometry(k, n))
    w8a16_cuda.launches += 1
    return out


def w8a16_splitk_cuda(x2, values, scale):
    """CUDA kernel for `_w8a16_2d_kernel`'s contract (the same function
    as `w8a16_cuda`, and the same body and geometry, for the K >= 8192
    products that `kernel_route` sends here). `launches` counts."""
    k, n = values.shape
    _check_cuda(x2, values, scale, n, k, 64)
    out = _launch_splitk("prt_w8a16_splitk", x2, values, scale, k, n,
                         w8a16_splitk_geometry(k, n))
    w8a16_splitk_cuda.launches += 1
    return out


def _launch_splitk(fn_name: str, x2, w, scale, k: int, n: int,
                   geo: "SplitKGeometry") -> torch.Tensor:
    """`prt_w8a16`, `prt_w8a16_splitk` or `prt_w4a16` at `geo`, on the
    current stream's scratch; returns the (B, N) f32 result."""
    out = _out(x2, n)
    # one chunk writes out directly and reads no scratch
    part, tickets = _tile2d_scratch(
        x2.device, geo.chunks * x2.shape[0] * n if geo.chunks > 1 else 0,
        geo.tickets)
    xp = _pad_x(x2, halves=fn_name == "prt_w4a16")
    _launch(fn_name, x2.device, xp.data_ptr(), w.data_ptr(), scale.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), out.data_ptr(), x2.shape[0],
            k, n, geo.k_chunk)
    return out


def w8a16_splitk_chunked_plain(x2, values, scale,
                               k_chunk: Optional[int] = None):
    """The plain w8a16 in the order of chunks of #14 and #17: x rounded to
    bf16, one f32 matmul per chunk of `k_chunk` K rows (by default the
    chunk of `w8a16_splitk_geometry`; TF32 off), the partials summed in
    chunk order, the scale last."""
    k, n = values.shape
    if k_chunk is None:
        k_chunk = w8a16_splitk_geometry(k, n).k_chunk
    return w8a16_2d_plain(x2, values, scale, k_chunk)


def w8a16_nt_cuda(x2, values, scale):
    """CUDA kernel for `_w8a16_nt_kernel`'s contract: x (B, K) bf16,
    values (N, K) int8, scale (N, 1) f32 -> (B, N) f32, on the tensor cores
    (`w8a16_nt_geometry`). `launches` counts."""
    n, k = values.shape
    if k % 16:
        raise ValueError(f"#15: K={k} must be a multiple of 16 (16-byte "
                         "loads of the (N, K) weight rows; ROADMAP section 3)")
    _check_cuda(x2, values, scale, n, k, 1, pads_x=False)
    out = _out(x2, n)
    _launch("prt_w8a16_nt", x2.device, x2.data_ptr(), values.data_ptr(),
            scale.data_ptr(), out.data_ptr(), x2.shape[0], k, n)
    w8a16_nt_cuda.launches += 1
    return out


def w4a16_cuda(x2, packed, scale):
    """CUDA kernel for `_w4a16_kernel`'s contract: x (B, K) bf16, packed
    (K/2, N) int8 (two int4 values a byte, K-half layout), scale (1, N) f32
    -> (B, N) f32. One launch over 64-column strips times chunks of packed
    rows (`w4a16_geometry`, a function of (K, N) alone); the last block of
    each strip sums its chunks' partials in chunk order. Assumes the
    launches that share a stream's scratch run in stream order
    (`_tile2d_scratch`). `launches` counts."""
    kh, n = packed.shape
    _check_cuda(x2, packed, scale, n, 2 * kh, 64)
    out = _launch_splitk("prt_w4a16", x2, packed, scale, 2 * kh, n,
                         w4a16_geometry(2 * kh, n))
    w4a16_cuda.launches += 1
    return out


def w4a16_chunked_plain(x2, packed, scale):
    """The plain w4a16 in #18's order of chunks: x rounded to bf16, one f32
    matmul per chunk of packed rows of `w4a16_geometry` (its low-nibble
    rows against x's first half, plus its high-nibble rows against the
    second; TF32 off), the partials summed in chunk order, the scale last.
    With one chunk it is `dequant_matmul_int4_reference` up to the order of
    the f32 sum."""
    kh, n = packed.shape
    geo = w4a16_geometry(2 * kh, n)
    lo, hi = unpack_int4(packed)
    xf = x2.bfloat16().float()
    acc = None
    with full_f32():
        for p0 in range(0, kh, geo.k_chunk):
            p1 = min(kh, p0 + geo.k_chunk)
            p = (xf[:, p0:p1] @ lo[p0:p1].float()
                 + xf[:, kh + p0:kh + p1] @ hi[p0:p1].float())
            acc = p if acc is None else acc + p
    return acc * scale


def w8a8_cuda(x_q, values, scale):
    """CUDA kernel for `_w8a8_kernel`'s contract: x_q (B, K) int8, values
    (K, N) int8, scale (1, N) f32 -> f32(int32 sum) * scale, (B, N) f32; the
    caller applies the activation scale. One launch on the int8 tensor
    cores over 64-column strips times spans of whole chunks of K rows
    (`w8a8_geometry`, a function of (K, N) alone); a strip's spans add
    their int32 sums in the shared memory of one of them (a cluster of up
    to 8 blocks) or in `_w8a8_scratch`. Assumes the launches that share a
    stream's scratch run in stream order. `launches` counts."""
    k, n = values.shape
    if k > W8A8_MAX_K:
        raise ValueError(f"w8a8: K={k} exceeds {W8A8_MAX_K} (the int32 sum "
                         "of 127 * 127 products)")
    _check_cuda(x_q, values, scale, n, k, 64, x_dtype=torch.int8)
    geo = w8a8_geometry(k, n)
    out = _out(x_q, n)
    # one chunk writes out directly and reads no scratch
    sums, tickets = _w8a8_scratch(
        x_q.device, x_q.shape[0] * n if geo.chunks > 1 else 0, geo.tickets)
    xp = _pad_x(x_q)
    _launch("prt_w8a8", x_q.device, xp.data_ptr(), values.data_ptr(),
            scale.data_ptr(), sums.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), x_q.shape[0], k, n, geo.k_chunk)
    w8a8_cuda.launches += 1
    return out


# (device index, stream) -> (partials, tickets) of prt_w8a16_tile2d,
# prt_w8a16, prt_w8a16_splitk and prt_w4a16
_TILE2D_SCRATCH: dict = {}
# (device index, stream) -> (int32 sums, tickets) of prt_w8a8, kept 0
_W8A8_SCRATCH: dict = {}
# the largest tile the kernel's limits admit (the tile only orders the sum)
_TILE2D_MAX_BLOCK_N = 4096
# the kernel's unit: a strip of 64 columns times a chunk of a K tile, cut
# from the tile (at most 1,024 rows, no shorter than a 64-row ring stage)
# until there are two units per SM of the H100; a block streams a run of
# consecutive chunks of its strip (at most 1,024 K rows of x in shared
# memory), as few as leave at most two blocks per SM
_TILE2D_STRIP = 64
_TILE2D_CHUNK_MAX = 1024
_TILE2D_CHUNK_MIN = 64
_TILE2D_RUN_ROWS = 1024
_TILE2D_SLOTS = 2 * 132


class SplitKGeometry(NamedTuple):
    """One launch of `prt_w8a16`, `prt_w8a16_splitk` or `prt_w4a16`:
    `blocks` (the 1-D grid, N / 64 strips times `chunks`), `k_chunk`
    (weight rows of a chunk, packed rows for int4, a multiple of 16) and
    `tickets` (one per strip). The partials take chunks * rows * N floats
    when chunks > 1."""
    blocks: int
    chunks: int
    k_chunk: int
    tickets: int


# the unit of #14, #17 and #18: a strip of 64 columns times a chunk of
# weight rows. The chunk count doubles until the grid reaches about two
# blocks per SM of the H100, while a chunk keeps at least one row for each
# of a block's 64 K slices
_SPLITK_STRIP = 64
_SPLITK_BLOCKS = 256
_SPLITK_CHUNK_MIN = 64


def _splitk_geometry(rows: int, n: int) -> SplitKGeometry:
    """`rows` weight rows of N columns cut into chunks (see above)."""
    strips = n // _SPLITK_STRIP
    chunks = 1
    while (strips * chunks < _SPLITK_BLOCKS
           and rows // (2 * chunks) >= _SPLITK_CHUNK_MIN):
        chunks *= 2
    k_chunk = -(-rows // chunks)
    k_chunk += -k_chunk % 16
    chunks = -(-rows // k_chunk)
    return SplitKGeometry(blocks=strips * chunks, chunks=chunks,
                          k_chunk=k_chunk, tickets=strips)


def w4a16_geometry(k: int, n: int) -> SplitKGeometry:
    """The launch geometry of #18 for a (rows, K) x (K/2 packed, N)
    product: a function of (K, N) alone, never of the row count, so a row
    gives the same bits alone as inside a batch. Llama-3.2-1B's int4
    projections: k / v (2048, 512) 8 strips x 16 chunks of 64 packed rows,
    q / o (2048, 2048) 32 x 8 of 128, gate / up (2048, 8192) 128 x 2 of 512,
    down (8192, 2048) 32 x 8 of 512."""
    return _splitk_geometry(k // 2, n)


def w8a16_splitk_geometry(k: int, n: int) -> SplitKGeometry:
    """The launch geometry of #14 and #17 for a (rows, K) x (K, N) int8
    product: a function of (K, N) alone, never of the row count, so a row
    gives the same bits alone as inside a batch. Llama-3.2-1B: #14's k / v
    (2048, 512) 8 strips x 32 chunks of 64 rows, q / o (2048, 2048) 32 x 8
    of 256, gate / up (2048, 8192) 128 x 2 of 1,024; #17's down projection
    (8192, 2048) 32 x 8 of 1,024."""
    return _splitk_geometry(k, n)


class W8A8Geometry(NamedTuple):
    """The units of `prt_w8a8`: `strips` 64-column strips times `chunks`
    chunks of `k_chunk` K rows (a multiple of 32, at most 1,024, the last
    one ragged), `units` of them. A block takes a strip and a span of whole
    chunks: up to 2,048 rows up to 16 activation rows, 1,024 above.
    `tickets`: one a strip. With chunks > 1 the int32 sums take rows * N
    values."""
    units: int
    strips: int
    chunks: int
    k_chunk: int
    tickets: int


# the unit of #16: a strip of 64 columns times a chunk of K rows, at most
# the 1,024 rows a block holds in registers (4 steps of 32 rows for each of
# its 8 warps). The chunk count doubles until there are about two units per
# SM of the H100, while a chunk keeps a step for each warp
_W8A8_UNITS = 256
_W8A8_CHUNK_MIN = 256
_W8A8_CHUNK_MAX = 1024
# the int32 sum of K products of two int8 in [-127, 127]: 127^2 K < 2^31
W8A8_MAX_K = (2 ** 31 - 1) // 127 ** 2


def w8a8_geometry(k: int, n: int) -> W8A8Geometry:
    """The launch geometry of #16 for a (rows, K) x (K, N) int8 product: a
    function of (K, N) alone. The int32 sum is exact, so no geometry changes
    a bit of the result; this one fills the card. Llama-3.2-1B: gate / up
    (2048, 8192) 128 strips x 2 chunks of 1,024, down (8192, 2048) 32 x 8
    of 1,024."""
    strips = n // 64
    chunks = -(-k // _W8A8_CHUNK_MAX)
    while (strips * chunks < _W8A8_UNITS
           and k // (2 * chunks) >= _W8A8_CHUNK_MIN):
        chunks *= 2
    k_chunk = -(-k // chunks)
    k_chunk += -k_chunk % 32
    chunks = -(-k // k_chunk)
    return W8A8Geometry(units=strips * chunks, strips=strips, chunks=chunks,
                        k_chunk=k_chunk, tickets=strips)


class NtGeometry(NamedTuple):
    """One launch of `prt_w8a16_nt`: `n8_tiles` activation tiles of 8 rows
    a pass, `passes` over the weights; the weight rows fall into `groups`
    of `group_rows` (8 warps of 16-row mma tiles), walked by a persistent
    grid of `blocks` (at most the blocks that fit the card at once)."""
    n8_tiles: int
    group_rows: int
    groups: int
    blocks: int
    passes: int


def w8a16_nt_geometry(rows: int, n: int, dev: torch.device) -> NtGeometry:
    """The launch that #15 makes for (rows, K) x (N, K) on the card `dev`,
    as its C entry reports it (`prt_w8a16_nt_geometry`, which picks the
    kernel for the launch too). Every output element sums the same mma
    steps in K order whatever the geometry."""
    from persian_rag_tpu_torch.ops import _build

    if dev.type != "cuda":
        raise ValueError(f"#15's geometry is the card's, got {dev}")
    lib = _build.load()
    geo = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        err = lib.prt_w8a16_nt_geometry(rows, n, geo)
    _build.check(lib, err, "prt_w8a16_nt_geometry")
    return NtGeometry(*geo)


class Tile2dGeometry(NamedTuple):
    """One launch of `prt_w8a16_tile2d`: `blocks` (the 1-D grid, N / 64
    strips times runs of `run` chunks), `k_chunk` (K rows of a chunk, a
    divisor of block_k), `run` (chunks a block sums, each into its own
    partial), `tickets` (one per strip) and `scratch_floats` (the f32
    partials, one (rows, N) plane per chunk)."""
    blocks: int
    k_chunk: int
    run: int
    tickets: int
    scratch_floats: int


def tile2d_geometry(rows: int, k: int, n: int, block_k: int) -> Tile2dGeometry:
    """The launch geometry of #19 for a (rows, K) x (K, N) product summed
    in K tiles of block_k rows. A function of (K, N, block_k) alone, so the
    bits of a column depend neither on block_n nor on the rows beside it
    (and not on `run`: a chunk's partial is summed alike by any block). A
    tile is cut into the fewest chunks (of at most 1,024 rows, a multiple
    of 16 dividing block_k) that give two per SM, while a chunk keeps a
    64-row ring stage; then a block takes the fewest consecutive chunks
    that leave at most two blocks per SM, up to 1,024 K rows."""
    strips, tiles = n // _TILE2D_STRIP, k // block_k
    m = block_k // 16
    cuts = [s for s in range(1, m + 1)
            if m % s == 0 and block_k // s <= _TILE2D_CHUNK_MAX]
    split = cuts[0]
    for s in cuts:
        if block_k // s < _TILE2D_CHUNK_MIN:
            break
        split = s
        if strips * tiles * s >= _TILE2D_SLOTS:
            break
    k_chunk, chunks = block_k // split, tiles * split
    longest = max(1, _TILE2D_RUN_ROWS // k_chunk)
    run = next((r for r in range(1, longest + 1)
                if strips * -(-chunks // r) <= _TILE2D_SLOTS), longest)
    return Tile2dGeometry(blocks=strips * -(-chunks // run), k_chunk=k_chunk,
                          run=run, tickets=strips,
                          scratch_floats=chunks * rows * n)


def _check_tile(rows: int, k: int, n: int, block_n: int, block_k: int):
    """The limits of `prt_w8a16_tile2d`'s (block_n, block_k) grid."""
    if not 1 <= rows <= _MAX_KERNEL_ROWS:
        raise ValueError(f"x must have 1..{_MAX_KERNEL_ROWS} rows, got {rows}")
    if block_n % 64 or not 64 <= block_n <= _TILE2D_MAX_BLOCK_N:
        raise ValueError(f"block_n={block_n} must be a multiple of 64 in "
                         f"64..{_TILE2D_MAX_BLOCK_N}")
    if n % block_n:
        raise ValueError(f"block_n={block_n} must divide N={n}")
    if block_k % 16 or block_k < 16 or k % block_k:
        raise ValueError(
            f"block_k={block_k} must be a multiple of 16 dividing K={k}")
    if k // block_k > 65535:
        raise ValueError(f"K / block_k = {k // block_k} tiles exceeds 65,535")


def _w8a8_scratch(dev: torch.device, ints: int, tickets: int):
    """The int32 sums and ticket counters of `prt_w8a8` on the current
    stream of `dev`, grown to hold `ints` and `tickets`. Both are zeroed
    when allocated, and every launch leaves them 0. Calls on one stream
    run in order, so they share these safely; a call on another stream
    gets its own."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    sums, counters = _W8A8_SCRATCH.get(key, (None, None))
    if sums is None or sums.numel() < max(ints, 4):
        sums = torch.zeros(max(ints, 4), dtype=torch.int32, device=dev)
    if counters is None or counters.numel() < tickets:
        counters = torch.zeros(tickets, dtype=torch.int32, device=dev)
    _W8A8_SCRATCH[key] = (sums, counters)
    return sums, counters


def _tile2d_scratch(dev: torch.device, floats: int, tickets: int):
    """The partials buffer and ticket counters of the current stream of
    `dev` (shared by `prt_w8a16_tile2d`, `prt_w8a16`, `prt_w8a16_splitk`
    and `prt_w4a16`), grown to hold `floats` and `tickets`. The tickets are zeroed once, when
    allocated, and every launch leaves them 0. Calls on one
    stream run in order, so they share these safely; a call on another
    stream gets its own, since two launches that run at the same time must
    not share them."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    part, counters = _TILE2D_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < tickets:
        counters = torch.zeros(tickets, dtype=torch.int32, device=dev)
    _TILE2D_SCRATCH[key] = (part, counters)
    return part, counters


def w8a16_2d_cuda(x2, values, scale, block_n: int, block_k: int):
    """CUDA kernel for the matvec probe's 2-D tile kernel
    (`scripts/bench_matvec_probe.py`, `w8a16_2d_call`): x (B, K) bf16,
    values (K, N) int8, scale (1, N) f32 -> (B, N) f32, the f32 partials
    of the K tiles of block_k rows summed in tile order, then scaled: one
    launch over 64-column strips times runs of tile chunks
    (`tile2d_geometry`), the last block of each strip summing its
    partials. block_n is held to
    the probe's limits but does not change the result. Assumes the
    launches that share a stream's scratch run in stream order
    (`_tile2d_scratch`). `launches` counts."""
    k, n = values.shape
    _check_tile(x2.shape[0], k, n, block_n, block_k)
    _check_cuda(x2, values, scale, n, k, 64, pads_x=False)
    out = _out(x2, n)
    geo = tile2d_geometry(x2.shape[0], k, n, block_k)
    part, tickets = _tile2d_scratch(x2.device, geo.scratch_floats,
                                    geo.tickets)
    _launch("prt_w8a16_tile2d", x2.device, x2.data_ptr(), values.data_ptr(),
            scale.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), x2.shape[0], k, n, block_n, block_k, geo.k_chunk,
            geo.run)
    w8a16_2d_cuda.launches += 1
    return out


def w8a16_2d_plain(x2, values, scale, block_k: int):
    """The plain version of the tile kernels (#19, the probe's inline
    kernel, and #17's TPU schedule): x rounded to bf16, one f32 matmul per
    K tile of `block_k` rows (TF32 off), the partials summed in tile order,
    the scale last. With block_k = K it is `dequant_matmul_reference`."""
    xf = x2.bfloat16().float()
    w = values.float()
    acc = None
    with full_f32():
        for k0 in range(0, w.shape[0], block_k):
            p = xf[:, k0:k0 + block_k] @ w[k0:k0 + block_k]
            acc = p if acc is None else acc + p
    return acc * scale


for _fn in (w8a16_cuda, w8a16_splitk_cuda, w8a16_nt_cuda, w4a16_cuda,
            w8a8_cuda, w8a16_2d_cuda):
    _fn.launches = 0

KERNELS = {
    "w8a16": w8a16_cuda,
    "w8a16_nt": w8a16_nt_cuda,
    "w8a16_splitk": w8a16_splitk_cuda,
    "w4a16": w4a16_cuda,
    "w8a8": w8a8_cuda,
}

PLAIN = {
    "w8a16": _w8a16_plain,
    "w8a16_nt": _w8a16_nt_plain,
    "w8a16_splitk": _w8a16_plain,
    "w4a16": dequant_matmul_int4_reference,
    "w8a8": _w8a8_plain,
}


# ---------------------------------------------------------------------------
# Dispatching entries.
# ---------------------------------------------------------------------------


def kernel_route(rows: int, k: int, n: int, nt: bool = False,
                 kind: str = "w8a16") -> Optional[str]:
    """Which kernel a (rows, K) x (K, N) product goes to, or None for the
    library route. `kind` is the weight format: "w8a16" (-> "w8a16",
    "w8a16_splitk", or "w8a16_nt" with nt), "w4a16" or "w8a8" (K is the
    activations' width in both). w8a8 raises on N % 128 != 0, as the JAX
    package's block picker does."""
    if rows > _MAX_KERNEL_ROWS or rows == 0:
        return None
    if kind == "w8a8":
        if n % 128:
            raise ValueError(f"w8a8: N={n} must be a multiple of 128")
        return "w8a8"
    if n % 128:
        return None
    if kind == "w4a16":
        return "w4a16"
    if kind != "w8a16":
        raise ValueError(f"unknown weight format {kind!r}")
    if nt:
        return "w8a16_nt"
    if k >= W8A16_SPLIT_K and n % 1024 == 0 and k % 256 == 0:
        return "w8a16_splitk"
    return "w8a16"


def _run(name: str, x2, values, scale):
    """The kernel `name` on CUDA tensors, its plain version on CPU ones."""
    dev = x2.device.type
    if dev == "cpu":
        return PLAIN[name](x2, values, scale)
    if dev == "cuda":
        return KERNELS[name](x2.contiguous(), values, scale)
    raise ValueError(f"no {name} kernel for device type {dev}")


def _flatten(x, values, scale, k: int):
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the weights K={k}")
    if values.device != x.device or scale.device != x.device:
        raise ValueError("activations and weights must be on one device")
    return x.reshape(-1, k)


def _dispatch(x, values, scale, nt: bool):
    n, k = values.shape if nt else values.shape[::-1]
    x2 = _flatten(x, values, scale, k)
    name = kernel_route(x2.shape[0], k, n, nt)
    if name is None:
        return dequant_matmul_reference(x, values, scale, nt=nt)
    return _run(name, x2.bfloat16(), values, scale).reshape(*x.shape[:-1], n)


def w8a16_matmul(x: torch.Tensor, values: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(values (K, N) int8, scale (1, N)) -> f32."""
    return _dispatch(x, values, scale, nt=False)


def w8a16_matmul_nt(x: torch.Tensor, values: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(values (N, K) int8, scale (N, 1)).T -> f32.

    The (N, K) row-major-by-output layout lets the tied lm_head reuse the
    embedding's int8 table without a transposed copy."""
    return _dispatch(x, values, scale, nt=True)


def w4a16_matmul(x: torch.Tensor, packed: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant-int4(packed (K/2, N), scale (1, N)) -> f32."""
    kh, n = packed.shape
    x2 = _flatten(x, packed, scale, 2 * kh)
    if kernel_route(x2.shape[0], 2 * kh, n, kind="w4a16") is None:
        return dequant_matmul_int4_reference(x, packed, scale)
    return _run("w4a16", x2.bfloat16(), packed, scale).reshape(
        *x.shape[:-1], n)


def w8a16_2d(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
             *, block_n: int, block_k: int) -> torch.Tensor:
    """x (..., K) @ dequant(values (K, N) int8, scale (1, N)) -> f32 on a
    (block_n, block_k) tile grid: `w8a16_2d_cuda` on CUDA tensors,
    `w8a16_2d_plain` on CPU ones (both held to the kernel's limits)."""
    k, n = values.shape
    x2 = _flatten(x, values, scale, k).bfloat16()
    dev = x2.device.type
    if dev == "cpu":
        _check_tile(x2.shape[0], k, n, block_n, block_k)
        out = w8a16_2d_plain(x2, values, scale, block_k)
    elif dev == "cuda":
        out = w8a16_2d_cuda(x2.contiguous(), values, scale, block_n, block_k)
    else:
        raise ValueError(f"no w8a16_2d kernel for device type {dev}")
    return out.reshape(*x.shape[:-1], n)


def w8a8_matmul(x: torch.Tensor, values: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Dynamic per-row activation quantization + an int8 x int8 product:
    out = f32(q(x) @ values, int32 sum) * scale * x_scale -> f32. Above
    256 rows the w8a16 convert-and-matmul route (no activation
    quantization), as in the JAX package."""
    k, n = values.shape
    x2 = _flatten(x, values, scale, k)
    if kernel_route(x2.shape[0], k, n, kind="w8a8") is None:
        return dequant_matmul_reference(x, values, scale, nt=False)
    x_q, x_scale = quantize_rows(x2)
    out = _run("w8a8", x_q, values, scale) * x_scale
    return out.reshape(*x.shape[:-1], n)
