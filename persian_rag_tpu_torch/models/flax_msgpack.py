"""Flax's msgpack state-dict format, read and written without flax.

``flax.serialization.to_bytes`` writes a parameter tree as one msgpack
document; the JAX package's fine-tuned models (``params.msgpack``) are
such files. This module reads and writes the same bytes in plain Python
and numpy, as ``models/hf_loader.py`` reads safetensors:

* maps keep their insertion order (Flax trees are ordered ``layer_0``,
  ``layer_1``, ..., ``layer_10``, not sorted);
* msgpack ext type 1 is an ndarray: its payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``; ext type 3 is a numpy scalar in
  the same encoding; any other ext type raises;
* a list or tuple is written as flax's state dict writes it, a map keyed
  ``"0", "1", ...``;
* an array past `MAX_CHUNK_SIZE` bytes (flax's 2^30) is written as
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat part, ...}}`` and joined again on reading.

Every number takes msgpack-python's smallest encoding, so a tree written
here has the bytes flax writes for it. Arrays are read into torch tensors
(``bfloat16`` as ``torch.bfloat16``, which numpy lacks); numpy arrays,
numpy scalars and tensors are written. Reading streams each array into
its own buffer, so a file is never held twice in memory.
"""
from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO, Dict, Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: msgpack's objects stop at 2^31 - 1
MAX_CHUNK_SIZE = 2 ** 30


# -- writing -------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack("b", v)
    if 128 <= v <= 0xFF:
        return b"\xcc" + struct.pack(">B", v)
    if -0x80 <= v < 0:
        return b"\xd0" + struct.pack(">b", v)
    if 0xFF < v <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", v)
    if -0x8000 <= v < -0x80:
        return b"\xd1" + struct.pack(">h", v)
    if 0xFFFF < v <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", v)
    if -0x80000000 <= v < -0x8000:
        return b"\xd2" + struct.pack(">i", v)
    if 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", v)
    if -0x8000000000000000 <= v < -0x80000000:
        return b"\xd3" + struct.pack(">q", v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _sized(n: int, fix: int, fix_max: int, codes: bytes) -> bytes:
    """A str / bin / array / map header: a fix form below fix_max (fix < 0:
    none), then 8- (str, bin), 16- and 32-bit lengths."""
    if fix >= 0 and n < fix_max:
        return bytes((fix | n,))
    widths = ">B", ">H", ">I"
    limits = 0xFF, 0xFFFF, 0xFFFFFFFF
    first = 3 - len(codes)  # arrays and maps have no 8-bit form
    for code, fmt, limit in zip(codes, widths[first:], limits[first:]):
        if n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack length {n} past 2^32 - 1")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), 0xA0, 32, b"\xd9\xda\xdb") + data


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes((fixed[n], code))
    if n <= 0xFF:
        return b"\xc7" + struct.pack(">BB", n, code)
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">HB", n, code)
    if n <= 0xFFFFFFFF:
        return b"\xc9" + struct.pack(">IB", n, code)
    raise OverflowError(f"msgpack ext payload of {n} bytes past 2^32 - 1")


def _as_numpy(leaf) -> np.ndarray:
    """A leaf's host array (a torch.bfloat16 tensor as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16 if hasattr(torch, "uint16")
                             else torch.int16).numpy()
        return leaf.numpy()
    # np.ascontiguousarray would make a 0-d scalar 1-d
    return np.asarray(leaf, order="C")


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return arr.dtype.name


def _write_array(f: BinaryIO, leaf, code: int = EXT_NDARRAY) -> None:
    arr = _as_numpy(leaf)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    head = (b"\x93" + _sized(len(arr.shape), 0x90, 16, b"\xdc\xdd")
            + b"".join(_int(int(d)) for d in arr.shape)
            + _str(_dtype_name(leaf, arr))
            + _sized(arr.nbytes, -1, 0, b"\xc4\xc5\xc6"))
    f.write(_ext_header(code, len(head) + arr.nbytes))
    f.write(head)
    f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _chunked(leaf) -> Dict[str, Any]:
    """flax.serialization._chunk: flat parts of MAX_CHUNK_SIZE bytes."""
    itemsize = leaf.element_size() if isinstance(
        leaf, torch.Tensor) else leaf.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    n = flat.shape[0]
    return {
        CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
        "chunks": {str(j): flat[i:i + step]
                   for j, i in enumerate(range(0, n, step))},
    }


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


def _write(f: BinaryIO, obj) -> None:
    if isinstance(obj, Mapping):
        f.write(_sized(len(obj), 0x80, 16, b"\xde\xdf"))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"tree keys are strings, not {key!r}")
            f.write(_str(key))
            if isinstance(value, (np.ndarray, torch.Tensor)) and (
                    _nbytes(value) > MAX_CHUNK_SIZE):
                value = _chunked(value)
            _write(f, value)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _write_array(f, obj)
    elif isinstance(obj, np.generic):
        _write_array(f, np.asarray(obj), EXT_NPSCALAR)
    elif obj is None:
        f.write(b"\xc0")
    elif obj is True or obj is False:
        f.write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        f.write(_int(obj))
    elif type(obj) is float:
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        f.write(_str(obj))
    elif type(obj) is bytes:
        f.write(_sized(len(obj), -1, 0, b"\xc4\xc5\xc6") + obj)
    elif isinstance(obj, (list, tuple)):
        # flax's state dict of a sequence: a map keyed "0", "1", ...
        _write(f, {str(i): value for i, value in enumerate(obj)})
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def write(f: BinaryIO, tree: Mapping) -> None:
    """Write `tree` (nested str-keyed dicts of tensors, numpy arrays or
    scalars, numbers, strings) to a binary file as flax would."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) and (
            _nbytes(tree) > MAX_CHUNK_SIZE):
        tree = _chunked(tree)
    _write(f, tree)


def to_bytes(tree: Mapping) -> bytes:
    buf = io.BytesIO()
    write(buf, tree)
    return buf.getvalue()


def save(path: str, tree: Mapping) -> None:
    with open(path, "wb") as f:
        write(f, tree)


# -- reading -------------------------------------------------------------------


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError("truncated msgpack data")
        return data

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return self.take(n)
            if b >= 0xD9 and b <= 0xDB:
                return self.take(n).decode("utf-8")
            if b in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        raise ValueError(f"msgpack byte 0x{b:02x} is not a type")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code: int, n: int):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(
                f"msgpack ext type {code} is not a flax ndarray (1) or "
                "numpy scalar (3)")
        start = self.f.tell()
        if self.take(1) != b"\x93":
            raise ValueError("an ndarray ext holds (shape, dtype, bytes)")
        shape = self.obj()
        name = self.obj()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.take(1)[0]
        size = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        bf16 = name == "bfloat16"
        dtype = np.dtype(np.int16 if bf16 else name)
        arr = np.empty(int(np.prod(shape, dtype=np.int64)), dtype)
        if arr.nbytes != size:
            raise ValueError(f"{name}{shape} does not take {size} bytes")
        if size and self.f.readinto(memoryview(arr).cast("B")) != size:
            raise ValueError("truncated msgpack data")
        if self.f.tell() - start != n:
            raise ValueError("ndarray ext payload length mismatch")
        tensor = torch.from_numpy(arr.reshape(shape))
        if bf16:
            tensor = tensor.view(torch.bfloat16)
        return tensor.reshape(()) if code == EXT_NPSCALAR else tensor


def _unchunk(tree):
    """flax.serialization._unchunk_array_leaves_in_place, recursively."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat(parts).reshape(shape)
        return {key: _unchunk(value) for key, value in tree.items()}
    return tree


def read(f: BinaryIO):
    """Read one flax msgpack document from a binary file: nested dicts
    whose array leaves are CPU tensors (a numpy scalar: a 0-d tensor)."""
    return _unchunk(_Reader(f).obj())


def from_bytes(data: bytes):
    return read(io.BytesIO(data))


def load(path: str):
    with open(path, "rb") as f:
        return read(f)
