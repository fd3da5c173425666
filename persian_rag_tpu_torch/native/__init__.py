"""ctypes loader for the native BM25 builder (``lexical_native.cpp``).

The source is compiled with g++ at first use into
``build/persian_rag_tpu_torch/native/<hash>/liblexical.so`` at the root of
the checkout (keyed by a hash of the source and the flags); importing this
module builds nothing. `available()` says whether it builds: a failed
compile is logged with the compiler's error, and `bm25_build_ell` raises it.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from persian_rag_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent / "lexical_native.cpp"
# beside the CUDA kernels' builds (ops._build imports nothing heavy)
BUILD_ROOT = _build.BUILD_ROOT / "native"
CXX_FLAGS = ["-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_warned = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblexical.so"


def _compile(path: Path) -> None:
    """g++ into a private name, then rename: a concurrent build never loads
    a half-written library. Raises RuntimeError with the compiler's
    output."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".so")
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as err:
            raise RuntimeError(f"{' '.join(cmd)}: {err}") from err
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        path = library_path()
        try:
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as err:
            _error = f"the native BM25 builder does not build: {err}"
            raise RuntimeError(_error) from err
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.bm25_build.restype = p
        lib.bm25_build.argtypes = [ctypes.c_char_p, p, i64, ctypes.c_double,
                                   ctypes.c_double]
        for name, restype in (("bm25_ell_width", i64),
                              ("bm25_vocab_size", i64),
                              ("bm25_vocab_bytes", i64),
                              ("bm25_avgdl", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = [p]
        for name, argtypes in (("bm25_export_df", [p, p]),
                               ("bm25_fill_ell", [p, p, p, p]),
                               ("bm25_export_vocab", [p, ctypes.c_char_p, p]),
                               ("bm25_free", [p])):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = argtypes
        _lib = lib
        return lib


def available() -> bool:
    """Whether the builder builds here; a failure is logged with the
    compiler's error (once)."""
    global _warned
    try:
        _load()
        return True
    except RuntimeError as err:
        if not _warned:
            logger.warning("%s; BM25 builds take the Python builder", err)
            _warned = True
        return False


def bm25_build_ell(
    texts: List[str], k1: float = 1.5, b: float = 0.75,
    epsilon: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, int], Dict[str, float], float]:
    """Build the BM25 ELL natively: (doc_ids (N, L) int32, doc_vals (N, L)
    float32, vocab term -> id, idf term -> value, avgdl). The idf is the
    Python builder's (`index.lexical.bm25_idf`), handed to the C++ fill."""
    from persian_rag_tpu_torch.index.lexical import bm25_idf

    lib = _load()
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    handle = lib.bm25_build(b"".join(encoded), offsets.ctypes.data,
                            len(encoded), k1, b)
    try:
        ell = lib.bm25_ell_width(handle)
        vocab_size = lib.bm25_vocab_size(handle)
        avgdl = float(lib.bm25_avgdl(handle))
        vocab_buf = ctypes.create_string_buffer(
            max(lib.bm25_vocab_bytes(handle), 1))
        vocab_offsets = np.empty(vocab_size + 1, np.int64)
        lib.bm25_export_vocab(handle, vocab_buf, vocab_offsets.ctypes.data)
        raw = vocab_buf.raw
        terms = [raw[vocab_offsets[i]:vocab_offsets[i + 1]].decode("utf-8")
                 for i in range(vocab_size)]
        df = np.empty(vocab_size, np.int64)
        lib.bm25_export_df(handle, df.ctypes.data)
        idf = bm25_idf(terms, df.tolist(), len(encoded), epsilon)
        idf_arr = np.asarray([idf[t] for t in terms], np.float64)
        ids = np.empty((len(encoded), ell), np.int32)
        vals = np.empty((len(encoded), ell), np.float32)
        lib.bm25_fill_ell(handle, idf_arr.ctypes.data, ids.ctypes.data,
                          vals.ctypes.data)
    finally:
        lib.bm25_free(handle)
    return ids, vals, {t: i for i, t in enumerate(terms)}, idf, avgdl
