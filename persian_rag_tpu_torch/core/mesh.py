"""Device mesh and sharding helpers.

The counterpart of ``persian_rag_tpu.core.mesh``: a 2-D ``(corpus, data)``
grid of devices,

* the ``corpus`` axis shards an index's rows; each shard searches its rows
  and the per-shard top-k lists merge on the mesh's first device
  (``persian_rag_tpu_torch.parallel.sharded_search``);
* the ``data`` axis splits batches for encoding and training.

One process drives every device of the mesh, as one JAX program drives
its mesh: a `Mesh` is a grid of ``torch.device``s, and the collectives are
explicit copies (``Tensor.to(device, non_blocking=True)``) to the merging
device, summed or merged there in fixed shard order. A device list may
repeat a device: one card then carries every shard of a mesh (and the
CPU tests build 8 shards on ``torch.device("cpu")``, where the JAX tests
use 8 virtual CPU devices). A copy to the device a tensor is already on
is no copy.

The JAX sharding helpers become functions that split a tensor into
per-device shards (`corpus_sharding`, `data_sharding`) or copy it to every
device (`replicated_sharding`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

CORPUS_AXIS = "corpus"
DATA_AXIS = "data"

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class MeshSpec:
    corpus: int
    data: int


class Mesh:
    """A (corpus, data) grid of devices. ``shape`` maps each axis name to
    its size, as a JAX mesh's does; ``devices[i][j]`` is the device of
    corpus shard i and data shard j."""

    axis_names = (CORPUS_AXIS, DATA_AXIS)

    def __init__(self, grid: Sequence[Sequence[DeviceLike]]):
        rows = tuple(tuple(torch.device(d) for d in row) for row in grid)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.devices = rows
        self.shape: Dict[str, int] = {CORPUS_AXIS: len(rows),
                                      DATA_AXIS: len(rows[0])}

    @property
    def device(self) -> torch.device:
        """The first device: where merged results and replicated state
        live."""
        return self.devices[0][0]

    @property
    def size(self) -> int:
        return self.shape[CORPUS_AXIS] * self.shape[DATA_AXIS]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along one axis at index 0 of the other."""
        if axis == CORPUS_AXIS:
            return [row[0] for row in self.devices]
        if axis == DATA_AXIS:
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh(corpus={self.shape[CORPUS_AXIS]}, "
                f"data={self.shape[DATA_AXIS]}, devices="
                f"{[[str(d) for d in r] for r in self.devices]})")


def check_mesh(mesh) -> Optional[Mesh]:
    """None, or a `Mesh`; anything else raises TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a persian_rag_tpu_torch Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def build_mesh(
    corpus_axis: int = -1,
    data_axis: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a 2-D ``(corpus, data)`` mesh, filled row-major.

    ``corpus_axis=-1`` takes every device not claimed by ``data_axis``.
    ``devices=None`` takes the CUDA devices (raises RuntimeError without
    CUDA); a grid larger than the device list raises ValueError. An
    explicit list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh() takes the CUDA devices and CUDA is not "
                "available; pass devices= (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data_axis <= 0:
        data_axis = 1
    if corpus_axis <= 0:
        corpus_axis = max(1, n // data_axis)
    if corpus_axis * data_axis > n:
        raise ValueError(
            f"mesh {corpus_axis}x{data_axis} needs {corpus_axis * data_axis} "
            f"devices, have {n}"
        )
    return Mesh([devices[i * data_axis:(i + 1) * data_axis]
                 for i in range(corpus_axis)])


def single_device_mesh(device: Optional[DeviceLike] = None) -> Mesh:
    """A (1, 1) mesh on `device` (None: the first CUDA device)."""
    return build_mesh(1, 1, devices=None if device is None else [device])


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_rows(x: torch.Tensor, n_rows: int, value=0) -> torch.Tensor:
    """x with rows appended up to `n_rows`, filled with `value`."""
    extra = n_rows - x.shape[0]
    if extra <= 0:
        return x
    pad = torch.full((extra,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _spread(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`t` on each device; one copy per distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
        out.append(copies[d])
    return out


def corpus_sharding(x: torch.Tensor, mesh: Mesh) -> List[List[torch.Tensor]]:
    """Row-shard `x` (rows a multiple of the corpus axis) over the corpus
    axis: ``out[i][j]`` is shard i on device ``mesh.devices[i][j]`` (each
    shard is replicated along the data axis, as P(corpus, None) places it
    on a 2-D mesh)."""
    n = mesh.shape[CORPUS_AXIS]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    parts = torch.chunk(x, n) if x.shape[0] else [x] * n
    return [_spread(p, row) for p, row in zip(parts, mesh.devices)]


def data_sharding(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Split a batch (rows a multiple of the data axis) over the data axis:
    shard j on ``mesh.devices[0][j]``."""
    n = mesh.shape[DATA_AXIS]
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {n}")
    return [p.to(d, non_blocking=True)
            for p, d in zip(torch.chunk(x, n), mesh.axis_devices(DATA_AXIS))]


def replicated_sharding(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """`x` on every device of the mesh, in row-major grid order."""
    return _spread(x, [d for row in mesh.devices for d in row])
