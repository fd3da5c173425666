"""models/flax_msgpack.py against flax.serialization, on the CPU.

Trees of every array dtype a parameter file holds (f32, f16, bf16, the
integer types, bool), numpy scalars, Python numbers and strings, nested
in insertion order (``layer_10`` after ``layer_2``): what flax writes, the
port reads with every array bit-equal; what the port writes, flax reads
bit-equal, and the bytes are flax's own. Arrays past MAX_CHUNK_SIZE take
the chunked form on both sides (the limit monkeypatched small).
"""
import msgpack
import numpy as np
import pytest
import torch

import flax.serialization as fs
import jax.numpy as jnp

from persian_rag_tpu_torch.models import flax_msgpack as fm

DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "int64",
          "uint8", "bool"]


def _array(rng, dtype, shape):
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=shape, dtype=dtype,
                            endpoint=True)
    return rng.standard_normal(shape).astype(dtype)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "encoder": {
            f"layer_{i}": {dtype: _array(rng, dtype, (3, 5 + i))
                           for dtype in DTYPES}
            for i in (0, 1, 2, 10)
        },
        "head": {},
        "scalars": {"f32": np.float32(0.25), "i8": np.int8(-7),
                    "f64": np.float64(1e300)},
        "python": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                            -1, -32, -33, -128, -129, -32768, -32769,
                            -2 ** 31 - 1, 2 ** 64 - 1],
                   "float": 1.5, "true": True, "none": None, "s": "س" * 40,
                   "long_key_" * 5: np.zeros((0, 4), np.float32)},
        "big": rng.standard_normal((40, 70)).astype(np.float32),
    }


def _paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _bits(value):
    """A leaf as comparable bits (bfloat16 as its uint16 pattern)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16)
        return value.numpy()
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":
        return value.view(np.uint16)
    return value


def _assert_same(got, tree):
    want = fs.to_state_dict(tree)  # a list is the map {"0": ..., "1": ...}
    got_paths, want_paths = list(_paths(got)), list(_paths(want))
    assert [p for p, _ in got_paths] == [p for p, _ in want_paths]
    for (path, g), (_, w) in zip(got_paths, want_paths):
        if isinstance(w, (np.ndarray, np.generic, torch.Tensor)):
            gb, wb = _bits(g), _bits(w)
            assert gb.shape == wb.shape and gb.dtype == wb.dtype, path
            np.testing.assert_array_equal(gb, wb, err_msg=str(path))
        else:
            assert g == w and type(g) is type(w), path


def _restored(tree):
    """The tree as the port reads it: arrays as tensors."""
    return fm.from_bytes(fs.to_bytes(tree))


@pytest.mark.parametrize("seed", [0, 1])
def test_port_reads_flax_bytes(seed):
    tree = _tree(seed)
    got = _restored(tree)
    _assert_same(got, tree)
    assert got["encoder"]["layer_2"]["bfloat16"].dtype == torch.bfloat16
    assert list(got["encoder"]) == ["layer_0", "layer_1", "layer_2",
                                    "layer_10"]
    assert got["scalars"]["f32"].shape == ()


@pytest.mark.parametrize("seed", [0, 1])
def test_flax_reads_port_bytes(seed):
    tree = _tree(seed)
    data = fm.to_bytes(tree)
    assert data == fs.to_bytes(tree)
    _assert_same(fs.msgpack_restore(data), tree)


def test_tensor_leaves_write_as_their_arrays():
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 6, generator=gen),
            "t": torch.randn(6, 4, generator=gen).T,  # not contiguous
            "h": torch.randn(2, 3, generator=gen).to(torch.bfloat16),
            "i": torch.arange(5, dtype=torch.int32)}
    _assert_same(fs.msgpack_restore(fm.to_bytes(tree)), tree)
    as_numpy = {k: np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16))
                if v.dtype == torch.bfloat16 else v.numpy()
                for k, v in tree.items()}
    assert fm.to_bytes(tree) == fs.to_bytes(as_numpy)


@pytest.mark.parametrize("limit", [64, 1000])
def test_chunked_arrays_both_ways(limit, monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", limit)
    tree = _tree(2)
    data = fs.to_bytes(tree)
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert raw["big"][fm.CHUNKED] is True
    assert len(raw["big"]["chunks"]) == -(-40 * 70 * 4 // limit)
    _assert_same(fm.from_bytes(data), tree)
    assert fm.to_bytes(tree) == data
    _assert_same(fs.msgpack_restore(fm.to_bytes(tree)), tree)


def test_files_round_trip(tmp_path):
    tree = _tree(3)
    fm.save(str(tmp_path / "params.msgpack"), tree)
    assert (tmp_path / "params.msgpack").read_bytes() == fs.to_bytes(tree)
    _assert_same(fm.load(str(tmp_path / "params.msgpack")), tree)


@pytest.mark.parametrize("payload", [
    msgpack.ExtType(2, msgpack.packb((1.0, 2.0))),  # flax's complex
    msgpack.ExtType(5, b"\x00" * 4),
])
def test_other_ext_types_raise(payload):
    with pytest.raises(ValueError, match="ext type"):
        fm.from_bytes(msgpack.packb({"x": payload}))


def test_truncated_data_raises():
    data = fs.to_bytes(_tree(0))
    with pytest.raises(ValueError, match="truncated"):
        fm.from_bytes(data[:-3])
