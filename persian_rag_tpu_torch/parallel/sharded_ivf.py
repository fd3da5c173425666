"""Corpus-sharded IVF search over the mesh's ``corpus`` axis.

The counterpart of ``persian_rag_tpu.parallel.sharded_ivf``:

* CELLS shard over the devices in contiguous cell-id ranges, with their
  slice of the centroid table (pad centroids sit at `_FAR`, so a probe
  never prefers them; their cells are empty), and the overflow block
  shards by rows. Every row lives in one cell or one overflow slice of
  one shard, so the merge never sees a row twice.
* each shard probes the top-min(nprobe, local cells) centroids of its
  LOCAL slice and scans those cells plus its overflow slice with the
  index's probe-and-scan (`index.ivf._ivf_search_step`), queries in
  chunks of 16. Each shard's local top-nprobe holds every globally
  top-nprobe cell it owns, so the probed cells are a SUPERSET of the
  single-device probe set and recall is at least the single-device
  IVF's at equal nprobe. A 1-shard mesh probes exactly the
  single-device cells.
* the per-shard top-k lists merge on the mesh's first device by (score
  descending, global id ascending); empty slots carry id -1 at the pad
  score and come last.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.core.mesh import CORPUS_AXIS, Mesh, pad_to_multiple
from persian_rag_tpu_torch.parallel.sharded_search import merge_by_score_id

_FAR = 1.0e18
QUERY_CHUNK = 16


def _pad(a: np.ndarray, rows: int, value) -> np.ndarray:
    if rows == a.shape[0]:
        return a
    pad = np.full((rows - a.shape[0],) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, pad])


def shard_ivf(
    centroids: np.ndarray,
    cells: np.ndarray,
    cell_ids: np.ndarray,
    overflow: Optional[np.ndarray],
    overflow_ids: Optional[np.ndarray],
    mesh: Mesh,
    dim: int,
) -> List[Tuple[torch.Tensor, ...]]:
    """Place IVF storage sharded: per corpus shard, on its device,
    (centroids, cells, cell_ids, cell sqnorms, overflow, overflow_ids,
    overflow sqnorms). A shard's overflow slice has at least one row (pad
    rows carry id -1), as in the JAX package."""
    n_shards = mesh.shape[CORPUS_AXIS]
    c_pad = pad_to_multiple(max(centroids.shape[0], n_shards), n_shards)
    centroids = _pad(np.asarray(centroids, np.float32), c_pad, _FAR)
    cells = _pad(np.asarray(cells, np.float32), c_pad, 0.0)
    cell_ids = _pad(np.asarray(cell_ids, np.int32), c_pad, -1)
    if overflow is None:
        overflow = np.zeros((0, dim), np.float32)
        overflow_ids = np.zeros((0,), np.int32)
    o_pad = pad_to_multiple(max(overflow.shape[0], n_shards), n_shards)
    overflow = _pad(np.asarray(overflow, np.float32), o_pad, 0.0)
    overflow_ids = _pad(np.asarray(overflow_ids, np.int32), o_pad, -1)
    c_loc, o_loc = c_pad // n_shards, o_pad // n_shards
    out = []
    for i, dev in enumerate(mesh.axis_devices(CORPUS_AXIS)):
        def put(a, rows):
            return torch.from_numpy(np.ascontiguousarray(
                a[i * rows:(i + 1) * rows])).to(dev)

        cl, ov = put(cells, c_loc), put(overflow, o_loc)
        out.append((put(centroids, c_loc), cl, put(cell_ids, c_loc),
                    torch.sum(cl * cl, dim=-1), ov, put(overflow_ids, o_loc),
                    torch.sum(ov * ov, dim=-1)))
    return out


def sharded_ivf_topk(
    queries: torch.Tensor,
    shards: List[Tuple[torch.Tensor, ...]],
    k: int,
    nprobe: int,
    metric: str,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe-and-scan a cell-sharded IVF index: ((Q, k) scores, (Q, k)
    int32 global ids) on the mesh's first device; l2 scores are squared
    distances ascending. Recall >= the single-device probe at equal
    nprobe (see the module docstring)."""
    from persian_rag_tpu_torch.index.ivf import _ivf_search_step

    parts_s, parts_i = [], []
    for cent, cells, cids, csq, ovf, ovf_ids, ovf_sq in shards:
        q = queries.to(cent.device, non_blocking=True)
        nprobe_local = min(nprobe, cent.shape[0])
        steps = [
            _ivf_search_step(
                q[s:s + QUERY_CHUNK], cent, cells, cids, csq, ovf, ovf_ids,
                ovf_sq, k=k, nprobe=nprobe_local, metric=metric)
            for s in range(0, q.shape[0], QUERY_CHUNK)
        ]
        parts_s.append(torch.cat([s for s, _ in steps]).to(mesh.device))
        parts_i.append(torch.cat([i for _, i in steps]).long().to(mesh.device))
    # _ivf_search_step maximizes (l2: negated distances)
    s, i = merge_by_score_id(torch.cat(parts_s, 1), torch.cat(parts_i, 1), k)
    if metric == "l2":
        s = -s
    return s, i.int()
