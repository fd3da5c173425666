"""First-party reader/writer for FAISS flat and IVF-flat index files.

The reference persists its corpora as FAISS ``IndexFlatL2`` files
(reference: src/create_embeddings.py:136, results/faiss/*.index) and
builds ``IndexIVFFlat`` for corpora over 1000 vectors (reference:
scripts/phase3_pdf_chunking.py:39-71). This module parses both binary
formats directly — no faiss dependency — so the reference's shipped
artifacts import as golden fixtures and exports remain loadable by faiss
users. A copy of ``persian_rag_tpu.index.faiss_io`` (numpy and ``struct``
only): the port imports nothing of the JAX package.

Flat format (faiss impl/index_write.cpp):
    fourcc   4 bytes  'IxF2' (METRIC_L2) | 'IxFI' (METRIC_INNER_PRODUCT)
    d        int32
    ntotal   int64
    dummy    2 x int64 (1<<20 each)
    trained  1 byte bool
    metric   int32 (0=IP, 1=L2)
    codes    uint64 byte-count-as-element-count, then ntotal*d float32

IVF-flat format ('IwFl'): the same header, then nlist/nprobe (uint64),
the embedded flat quantizer index, a direct-map (type byte + vector),
and ArrayInvertedLists ('ilar' + nlist + code_size + 'full' + per-list
sizes + per-list codes/int64 ids).
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

_FOURCC_L2 = b"IxF2"
_FOURCC_IP = b"IxFI"
_FOURCC_IVF = b"IwFl"
_FOURCC_ILAR = b"ilar"
_FOURCC_FULL = b"full"
_DUMMY = 1 << 20


def probe_faiss(path: str) -> str:
    """Peek at a faiss index file's fourcc: returns "flat" or "ivf"."""
    with open(path, "rb") as f:
        fourcc = f.read(4)
    if fourcc in (_FOURCC_L2, _FOURCC_IP):
        return "flat"
    if fourcc == _FOURCC_IVF:
        return "ivf"
    raise ValueError(f"{path}: unsupported faiss index fourcc {fourcc!r}")


def read_faiss_flat(path: str) -> Tuple[np.ndarray, str]:
    """Read a flat FAISS index file -> ((ntotal, d) float32, metric).

    metric is "l2" or "ip".
    """
    with open(path, "rb") as f:
        fourcc = f.read(4)
        if fourcc not in (_FOURCC_L2, _FOURCC_IP):
            raise ValueError(
                f"{path}: not a flat FAISS index (fourcc={fourcc!r}); "
                "only IndexFlatL2/IndexFlatIP files are supported"
            )
        d = struct.unpack("<i", f.read(4))[0]
        ntotal = struct.unpack("<q", f.read(8))[0]
        f.read(16)  # two dummy int64 fields
        f.read(1)  # is_trained
        metric_code = struct.unpack("<i", f.read(4))[0]
        n_elems = struct.unpack("<Q", f.read(8))[0]
        # faiss <=1.7.x serialized IndexFlat.xb as vector<float> (element
        # count = ntotal*d); newer IndexFlatCodes serializes vector<uint8>
        # (element count = ntotal*d*4). Accept both.
        if n_elems not in (ntotal * d, ntotal * d * 4):
            raise ValueError(
                f"{path}: codes size {n_elems} inconsistent with "
                f"ntotal={ntotal}, d={d}"
            )
        data = np.frombuffer(f.read(ntotal * d * 4), dtype="<f4").reshape(
            ntotal, d
        )
    metric = "ip" if metric_code == 0 else "l2"
    return np.ascontiguousarray(data), metric


def _read_flat_body(f: BinaryIO, fourcc: bytes) -> Tuple[np.ndarray, str]:
    """Header + codes of a flat index whose fourcc was already consumed."""
    d = struct.unpack("<i", f.read(4))[0]
    ntotal = struct.unpack("<q", f.read(8))[0]
    f.read(16)  # two dummy int64 fields
    f.read(1)  # is_trained
    metric_code = struct.unpack("<i", f.read(4))[0]
    n_elems = struct.unpack("<Q", f.read(8))[0]
    if n_elems not in (ntotal * d, ntotal * d * 4):
        raise ValueError(
            f"flat codes size {n_elems} inconsistent with "
            f"ntotal={ntotal}, d={d}"
        )
    data = np.frombuffer(f.read(ntotal * d * 4), dtype="<f4").reshape(
        ntotal, d
    )
    return np.ascontiguousarray(data), "ip" if metric_code == 0 else "l2"


def read_faiss_ivf(path: str) -> Dict:
    """Read a FAISS IndexIVFFlat file.

    Returns a dict with:
      vectors   (ntotal, d) float32 in insertion-id order
      metric    "l2" | "ip"
      centroids (nlist, d) float32 coarse quantizer
      assign    (ntotal,) int32 cell of each vector
      nprobe    int
    """
    with open(path, "rb") as f:
        fourcc = f.read(4)
        if fourcc != _FOURCC_IVF:
            raise ValueError(
                f"{path}: not an IndexIVFFlat file (fourcc={fourcc!r})"
            )
        d = struct.unpack("<i", f.read(4))[0]
        ntotal = struct.unpack("<q", f.read(8))[0]
        f.read(16)
        f.read(1)  # is_trained
        metric_code = struct.unpack("<i", f.read(4))[0]
        nlist = struct.unpack("<Q", f.read(8))[0]
        nprobe = struct.unpack("<Q", f.read(8))[0]
        q_fourcc = f.read(4)
        if q_fourcc not in (_FOURCC_L2, _FOURCC_IP):
            raise ValueError(
                f"{path}: unsupported quantizer fourcc {q_fourcc!r}"
            )
        centroids, _ = _read_flat_body(f, q_fourcc)
        # direct map: type byte + WRITEVECTOR(array of int64)
        f.read(1)
        dm_count = struct.unpack("<Q", f.read(8))[0]
        f.read(dm_count * 8)
        il_fourcc = f.read(4)
        if il_fourcc != _FOURCC_ILAR:
            raise ValueError(
                f"{path}: unsupported inverted-list fourcc {il_fourcc!r}"
            )
        il_nlist = struct.unpack("<Q", f.read(8))[0]
        code_size = struct.unpack("<Q", f.read(8))[0]
        if il_nlist != nlist or code_size != d * 4:
            raise ValueError(
                f"{path}: inverted lists nlist={il_nlist}/code_size="
                f"{code_size} inconsistent with header nlist={nlist}, d={d}"
            )
        list_type = f.read(4)
        if list_type != _FOURCC_FULL:
            raise ValueError(
                f"{path}: unsupported list storage {list_type!r}"
            )
        n_sizes = struct.unpack("<Q", f.read(8))[0]
        sizes = np.frombuffer(f.read(n_sizes * 8), dtype="<u8")
        vectors = np.zeros((ntotal, d), np.float32)
        assign = np.full(ntotal, -1, np.int32)
        for cell, n in enumerate(sizes):
            n = int(n)
            if n == 0:
                continue
            codes = np.frombuffer(
                f.read(n * code_size), dtype="<f4"
            ).reshape(n, d)
            ids = np.frombuffer(f.read(n * 8), dtype="<i8")
            vectors[ids] = codes
            assign[ids] = cell
    return {
        "vectors": vectors,
        "metric": "ip" if metric_code == 0 else "l2",
        "centroids": centroids,
        "assign": assign,
        "nprobe": int(nprobe),
    }


def write_faiss_ivf(
    path: str,
    vectors: np.ndarray,
    centroids: np.ndarray,
    assign: np.ndarray,
    metric: str = "l2",
    nprobe: int = 1,
) -> None:
    """Write an IndexIVFFlat file loadable by faiss.read_index."""
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    centroids = np.ascontiguousarray(centroids, dtype="<f4")
    n, d = vectors.shape
    nlist = centroids.shape[0]
    metric_code = 1 if metric == "l2" else 0
    with open(path, "wb") as f:
        f.write(_FOURCC_IVF)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", n))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<?", True))
        f.write(struct.pack("<i", metric_code))
        f.write(struct.pack("<Q", nlist))
        f.write(struct.pack("<Q", nprobe))
        # embedded flat quantizer
        f.write(_FOURCC_L2 if metric == "l2" else _FOURCC_IP)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", nlist))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<?", True))
        f.write(struct.pack("<i", metric_code))
        f.write(struct.pack("<Q", nlist * d))
        f.write(centroids.tobytes())
        # direct map: NoMapping + empty vector
        f.write(struct.pack("<b", 0))
        f.write(struct.pack("<Q", 0))
        # ArrayInvertedLists
        f.write(_FOURCC_ILAR)
        f.write(struct.pack("<Q", nlist))
        f.write(struct.pack("<Q", d * 4))
        f.write(_FOURCC_FULL)
        lists: List[np.ndarray] = [
            np.nonzero(assign == cell)[0] for cell in range(nlist)
        ]
        f.write(struct.pack("<Q", nlist))
        f.write(
            np.asarray([ids.size for ids in lists], dtype="<u8").tobytes()
        )
        for ids in lists:
            if ids.size:
                f.write(vectors[ids].tobytes())
                f.write(ids.astype("<i8").tobytes())


def write_faiss_flat(path: str, vectors: np.ndarray, metric: str = "l2") -> None:
    """Write an (N, d) float32 matrix as a faiss-loadable flat index."""
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    n, d = vectors.shape
    fourcc = _FOURCC_L2 if metric == "l2" else _FOURCC_IP
    metric_code = 1 if metric == "l2" else 0
    with open(path, "wb") as f:
        f.write(fourcc)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", n))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<q", _DUMMY))
        f.write(struct.pack("<?", True))
        f.write(struct.pack("<i", metric_code))
        # Element count as float count (faiss's canonical xb-vector form,
        # accepted by both legacy and current faiss readers).
        f.write(struct.pack("<Q", n * d))
        f.write(vectors.tobytes())
