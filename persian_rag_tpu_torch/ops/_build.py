"""Build and load the port's CUDA kernels.

The sources in ``persian_rag_tpu_torch/csrc/*.cu`` have a plain C
interface; ``nvcc`` compiles each to an object, all at once in parallel,
and links them into one shared library loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds).
The library goes to ``build/persian_rag_tpu_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and the nvcc command, and
is built at first use: importing this module builds nothing.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "persian_rag_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libprt_kernels.so"

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def _find_nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def _sources() -> List[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path; sets `build_seconds` when it compiled."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    nvcc = _find_nvcc()
    path.parent.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: a concurrent build never
    # loads a half-written library
    tmpdir = tempfile.mkdtemp(dir=path.parent)
    t0 = time.perf_counter()
    try:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("prt_extract_candidates_bf16",
                 "prt_extract_candidates_int8"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 5 + [i] * 6 + [p]
        fn.restype = i
    lib.prt_extract_candidates_bf16x2.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, p,
    ]
    lib.prt_extract_candidates_bf16x2.restype = i
    for name in ("prt_extract_candidates_bf16_geometry",
                 "prt_extract_candidates_bf16x2_geometry",
                 "prt_extract_candidates_int8_geometry"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        fn.restype = i
    lib.prt_extract_candidates_grouped.argtypes = [p, p, p, p] + [i] * 10 + [p]
    lib.prt_extract_candidates_grouped.restype = i
    lib.prt_grouped_geometry.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.prt_grouped_geometry.restype = i
    lib.prt_running_tile_topk.argtypes = [p, p, p, p] + [i] * 12 + [p]
    lib.prt_running_tile_topk.restype = i
    lib.prt_running_segment.argtypes = [p, p, p, p] + [i] * 12 + [p]
    lib.prt_running_segment.restype = i
    lib.prt_running_maxonly.argtypes = [p, p, p, p] + [i] * 9 + [p]
    lib.prt_running_maxonly.restype = i
    lib.prt_running_merge.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.prt_running_merge.restype = i
    for name in ("prt_sparse_topk", "prt_sparse_topk_hashed",
                 "prt_sparse_topk_union", "prt_sparse_topk_union_hashed"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 8 + [i] * 7 + [p]
        fn.restype = i
    for name in ("prt_sparse_topk_union_stage1",
                 "prt_sparse_topk_union_hashed_stage1"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 5 + [ctypes.c_longlong, p, p] + [i] * 6 + [p]
        fn.restype = i
    lib.prt_sparse_stage1_geometry.argtypes = [i] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.prt_sparse_stage1_geometry.restype = i
    lib.prt_sparse_topk_geometry.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.prt_sparse_topk_geometry.restype = i
    lib.prt_sparse_topk_hashed_geometry.argtypes = [i, i, ctypes.POINTER(i)]
    lib.prt_sparse_topk_hashed_geometry.restype = i
    lib.prt_w8a16_nt.argtypes = [p, p, p, p, i, i, i, p]
    lib.prt_w8a16_nt.restype = i
    for name in ("prt_w8a16", "prt_w8a16_splitk", "prt_w4a16", "prt_w8a8"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 6 + [i] * 4 + [p]
        fn.restype = i
    lib.prt_w8a16_nt_geometry.argtypes = [i, i, ctypes.POINTER(i)]
    lib.prt_w8a16_nt_geometry.restype = i
    lib.prt_w8a16_tile2d.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.prt_w8a16_tile2d.restype = i
    lib.prt_error_string.argtypes = [i]
    lib.prt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.prt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
