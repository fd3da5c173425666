"""Quantized weight-streaming matmuls for decode serving.

The counterpart of ``persian_rag_tpu.ops.quant_matmul``: weights are stored
int8 with a per-output-channel f32 scale, activations are bf16, and

    out = (x_bf16 . w_int8, accumulated in f32) * scale          -> f32

An int8 value is exact in bf16 and a bf16 x int8 product is exact in f32,
so the result is defined up to the order of the f32 sum.

Layouts:

* ``w8a16_matmul``    -- w stored (K, N), scale (1, N): every Dense layer.
* ``w8a16_matmul_nt`` -- w stored (N, K), scale (N, 1): the tied lm_head
  reads the embedding's own table, so quantized serving keeps no
  transposed copy of the vocabulary matrix.

Routing, as in the JAX package, so that each shape reaches the same kernel:

* more than ``_MAX_KERNEL_ROWS`` flattened rows (prefill) or an output
  width that is not a multiple of 128 -> ``dequant_matmul_reference``, the
  convert-and-matmul route (a plain f32 library product: the JAX package
  computes that route outside any kernel too);
* K >= ``W8A16_SPLIT_K`` with N % 1024 == 0 and K % 256 == 0 -> the
  split-K kernel (``_w8a16_2d_kernel`` there, ``prt_w8a16_splitk`` here);
* else the strip kernel (``_w8a16_kernel`` / ``prt_w8a16``); the nt entry
  goes to ``_w8a16_nt_kernel`` / ``prt_w8a16_nt``.

On CUDA tensors the kernel route launches the hand-written kernels of
``csrc/quant_matmul.cu`` or raises; on CPU tensors it runs the plain
version (``PLAIN``); any other device raises. ``KERNELS`` and ``PLAIN`` are
looked up at call time, keyed by kernel name.

Left behind: ``pick_block_n``, the 16-row batch padding, the 2 MB block
budget and the ``PRAG_W8A16_SPLIT_K`` environment switch are TPU
mechanics. int4 weights (``w4a16_matmul``) and int8 activations
(``w8a8_matmul``) are not ported yet and raise.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from persian_rag_tpu_torch.ops.flat_topk import full_f32

__all__ = [
    "quantize_weight",
    "quantize_weight_int4",
    "w8a16_matmul",
    "w8a16_matmul_nt",
    "w8a8_matmul",
    "w4a16_matmul",
    "dequant_matmul_reference",
]

# Above this many flattened rows the product is compute-bound and goes to
# the library route (prefill regime).
_MAX_KERNEL_ROWS = 256
# K from which the (K, N) product is cut into chunks across blocks.
W8A16_SPLIT_K = 8192
# K values per block of the split-K kernel
SPLIT_K_CHUNK = 1024

_LEFTOVER = "not ported yet: P3 leftovers (#18 / #16) in ROADMAP.md"


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


def quantize_weight_int4(w: torch.Tensor):
    raise NotImplementedError(f"int4 weights are {_LEFTOVER}")


def w4a16_matmul(x, packed, scale):
    raise NotImplementedError(f"w4a16_matmul is {_LEFTOVER}")


def w8a8_matmul(x, values, scale):
    raise NotImplementedError(f"w8a8_matmul is {_LEFTOVER}")


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


def _check_cuda(x2, values, scale, n: int, k: int, n_multiple: int):
    """What the C entries need of their inputs. Which shapes reach a kernel
    is decided by `kernel_route` alone (N % 128, the JAX package's gate);
    `n_multiple` only repeats the C entry's own limit (64-column strips; any
    N for nt), so that a direct caller of a wrapper gets a ValueError naming
    it instead of the entry's cudaErrorInvalidValue."""
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for name, t, dtype in (("x", x2, torch.bfloat16),
                           ("values", values, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = x2.shape[0]
    if x2.dim() != 2 or x2.shape[1] != k or not 1 <= rows <= _MAX_KERNEL_ROWS:
        raise ValueError(
            f"x must be (1..{_MAX_KERNEL_ROWS}, {k}), got {tuple(x2.shape)}")
    if k % 16:
        raise ValueError(
            f"K={k} must be a multiple of 16 (16-byte loads of int8 weights "
            "and aligned bf16 rows; ROADMAP section 3)")
    if n % n_multiple:
        raise ValueError(f"N={n} must be a multiple of {n_multiple}")
    if scale.numel() != n:
        raise ValueError(f"scale must hold {n} values, got {scale.numel()}")


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


def w8a16_cuda(x2, values, scale):
    """CUDA kernel for `_w8a16_kernel`'s contract: x (B, K) bf16, values
    (K, N) int8, scale (1, N) f32 -> (B, N) f32. `launches` counts."""
    k, n = values.shape
    _check_cuda(x2, values, scale, n, k, 64)
    out = _out(x2, n)
    _launch("prt_w8a16", x2.device, x2.data_ptr(), values.data_ptr(),
            scale.data_ptr(), out.data_ptr(), x2.shape[0], k, n)
    w8a16_cuda.launches += 1
    return out


def w8a16_splitk_cuda(x2, values, scale):
    """CUDA kernels for `_w8a16_2d_kernel`'s contract (the same function
    as `w8a16_cuda`, K cut into chunks across blocks): f32 partials per
    chunk, summed in chunk order by a second kernel. `launches` counts
    the pair as one."""
    k, n = values.shape
    _check_cuda(x2, values, scale, n, k, 64)
    out = _out(x2, n)
    part = torch.empty((-(-k // SPLIT_K_CHUNK), x2.shape[0], n),
                       dtype=torch.float32, device=x2.device)
    _launch("prt_w8a16_splitk", x2.device, x2.data_ptr(), values.data_ptr(),
            scale.data_ptr(), part.data_ptr(), out.data_ptr(), x2.shape[0],
            k, n, SPLIT_K_CHUNK)
    w8a16_splitk_cuda.launches += 1
    return out


def w8a16_nt_cuda(x2, values, scale):
    """CUDA kernel for `_w8a16_nt_kernel`'s contract: x (B, K) bf16,
    values (N, K) int8, scale (N, 1) f32 -> (B, N) f32. `launches`
    counts."""
    n, k = values.shape
    _check_cuda(x2, values, scale, n, k, 1)
    out = _out(x2, n)
    _launch("prt_w8a16_nt", x2.device, x2.data_ptr(), values.data_ptr(),
            scale.data_ptr(), out.data_ptr(), x2.shape[0], k, n)
    w8a16_nt_cuda.launches += 1
    return out


for _fn in (w8a16_cuda, w8a16_splitk_cuda, w8a16_nt_cuda):
    _fn.launches = 0

KERNELS = {
    "w8a16": w8a16_cuda,
    "w8a16_nt": w8a16_nt_cuda,
    "w8a16_splitk": w8a16_splitk_cuda,
}

PLAIN = {
    "w8a16": _w8a16_plain,
    "w8a16_nt": _w8a16_nt_plain,
    "w8a16_splitk": _w8a16_plain,
}


# ---------------------------------------------------------------------------
# Dispatching entries.
# ---------------------------------------------------------------------------


def kernel_route(rows: int, k: int, n: int, nt: bool = False) -> Optional[str]:
    """Which kernel a (rows, K) x (K, N) product goes to: "w8a16",
    "w8a16_splitk", "w8a16_nt", or None for the library route."""
    if rows > _MAX_KERNEL_ROWS or n % 128 or rows == 0:
        return None
    if nt:
        return "w8a16_nt"
    if k >= W8A16_SPLIT_K and n % 1024 == 0 and k % 256 == 0:
        return "w8a16_splitk"
    return "w8a16"


def _dispatch(x, values, scale, nt: bool):
    n, k = values.shape if nt else values.shape[::-1]
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the weights K={k}")
    if values.device != x.device or scale.device != x.device:
        raise ValueError("activations and weights must be on one device")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    name = kernel_route(x2.shape[0], k, n, nt)
    if name is None:
        return dequant_matmul_reference(x, values, scale, nt=nt)
    dev = x.device.type
    if dev == "cpu":
        out = PLAIN[name](x2, values, scale)
    elif dev == "cuda":
        out = KERNELS[name](x2.bfloat16().contiguous(), values, scale)
    else:
        raise ValueError(f"no {name} kernel for device type {dev}")
    return out.reshape(*lead, n)


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
