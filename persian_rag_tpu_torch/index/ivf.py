"""IVF (inverted-file) coarse-quantized index.

The counterpart of ``persian_rag_tpu.index.ivf`` on one device, with its
names, file formats and results:

* training is Lloyd k-means on the device (assignment by the l2 ranking
  of `flat_topk_ref`, centroid update by a segment sum);
* cells are padded to a fixed capacity: a search takes each query's
  top-nprobe centroids, gathers those cells' (cap, d) blocks and ranks
  their rows by a masked f32 contraction, plus an always-scanned overflow
  block;
* rows that overflow a cell's capacity spill to that overflow block, so a
  search loses no row to truncation (only the coarse quantization itself
  costs recall).

Arithmetic and order follow the JAX module: the scan and the l2 terms run
in f32 with TF32 off (`full_f32`, the JAX package's Precision.HIGHEST);
pads score -3.0e38; k past the candidates pads with id -1; a tie goes to
the lower position in the gathered (probe rank, slot) list, kept by a
stable sort. Queries are searched in chunks of `query_chunk`, which bounds
the (chunk, nprobe, cap, d) gather as the JAX package's `lax.map` does.

One chosen divergence: k-means draws its initial rows from a seeded CPU
`torch.Generator` (a random permutation's head), where the JAX package
draws them with `jax.random.choice`. `_lloyd` takes the initial rows, so
both packages can start from the same centroids. There is no Pallas
kernel on this path in the JAX package, and none here: the probe, scan and
training are torch ops.

With a `mesh` (``core.mesh``) the cells, centroids and overflow rows also
shard over the mesh's corpus axis (``parallel.sharded_ivf``) and every
search probes each shard's local cells; the index's device is the mesh's
first device, which keeps the unsharded storage for `rows`, `save` and
`export_faiss`. Sharded recall is at least the single-device probe's at
equal nprobe; ties among the merged lists go to the lower row id.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.core.mesh import check_mesh
from persian_rag_tpu_torch.index import faiss_io
from persian_rag_tpu_torch.ops.flat_topk import (
    _topk_desc,
    flat_topk_ref,
    full_f32,
)

PAD_SCORE = -3.0e38
ROW_CHUNK = 65_536  # rows a k-means assignment or segment sum takes at once


def _assign(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n,) int32 nearest centroid of each row: the top 1 of
    `flat_topk_ref`'s l2 ranking (maximize 2 v.c - ||c||^2), the lower cell
    on a tie (argmax returns the first maximum), in chunks of rows."""
    csq = torch.sum(centroids * centroids, dim=-1)
    out = []
    for start in range(0, vectors.shape[0], ROW_CHUNK):
        with full_f32():
            s = vectors[start : start + ROW_CHUNK] @ centroids.T
        out.append(torch.argmax(2.0 * s - csq[None, :], dim=1))
    return torch.cat(out).to(torch.int32)


def _segment_sum(
    vectors: torch.Tensor, assign: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """(n_cells, d) row sums per cell as one-hot contractions over chunks
    of rows: deterministic on the card, where an atomic scatter is not."""
    sums = torch.zeros((n_cells, vectors.shape[1]), dtype=torch.float32,
                       device=vectors.device)
    for start in range(0, vectors.shape[0], ROW_CHUNK):
        onehot = torch.nn.functional.one_hot(
            assign[start : start + ROW_CHUNK].long(), n_cells
        ).to(torch.float32)
        with full_f32():
            sums += onehot.T @ vectors[start : start + ROW_CHUNK]
    return sums


def _lloyd(
    vectors: torch.Tensor, init_idx: torch.Tensor, iters: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means from the rows `init_idx`, then a final assignment.
    Returns ((n_cells, d) f32 centroids, (n,) int32 cells). An empty cell
    keeps its centroid."""
    n_cells = int(init_idx.numel())
    centroids = vectors[init_idx.to(vectors.device).long()]
    for _ in range(iters):
        assign = _assign(vectors, centroids)
        sums = _segment_sum(vectors, assign, n_cells)
        counts = torch.bincount(assign.long(), minlength=n_cells).to(
            torch.float32)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids, _assign(vectors, centroids)


def _init_rows(n: int, n_cells: int, seed: int) -> torch.Tensor:
    """n_cells distinct rows drawn from a seeded CPU generator (the same
    draw on every device)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:n_cells]


def _kmeans_assign(
    vectors: torch.Tensor, n_cells: int, iters: int, seed: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means + final assignment: ((n_cells, d), (n,) int32)."""
    return _lloyd(vectors, _init_rows(vectors.shape[0], n_cells, seed), iters)


def kmeans(
    vectors: torch.Tensor, n_cells: int, iters: int = 10, seed: int = 0
) -> torch.Tensor:
    """Lloyd k-means on the vectors' device: (n_cells, d) f32 centroids."""
    return _kmeans_assign(vectors, n_cells, iters, seed)[0]


def _ivf_search_step(
    q: torch.Tensor,
    centroids: torch.Tensor,
    cells: torch.Tensor,
    cell_ids: torch.Tensor,
    cell_sq: torch.Tensor,
    overflow: Optional[torch.Tensor],
    overflow_ids: Optional[torch.Tensor],
    overflow_sq: Optional[torch.Tensor],
    *,
    k: int,
    nprobe: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe-and-scan of a chunk of queries: the top-nprobe centroids by
    l2, those cells' rows and the overflow block ranked by a masked f32
    contraction. Returns (scores maximized, int32 ids); l2 scores are
    negated squared distances (the caller flips them)."""
    _, probe = flat_topk_ref(q, centroids, nprobe, metric="l2")
    qn = q.shape[0]
    flat = cells[probe].reshape(qn, -1, cells.shape[2])  # (Q, P*cap, d)
    ids = cell_ids[probe].reshape(qn, -1)
    with full_f32():
        scores = torch.bmm(flat, q[:, :, None])[:, :, 0]
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    if metric == "l2":
        scores = -(qsq - 2.0 * scores + cell_sq[probe].reshape(qn, -1))
    if overflow is not None:
        with full_f32():
            o_scores = q @ overflow.T
        if metric == "l2":
            o_scores = -(qsq - 2.0 * o_scores + overflow_sq[None, :])
        scores = torch.cat([scores, o_scores], dim=1)
        ids = torch.cat([ids, overflow_ids[None, :].expand(qn, -1)], dim=1)
    scores = torch.where(ids >= 0, scores,
                         torch.full_like(scores, PAD_SCORE))
    k_eff = min(k, scores.shape[1])
    top_s, pos = _topk_desc(scores, k_eff)
    top_i = torch.gather(ids, 1, pos)
    if k_eff < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - k_eff),
                                        value=PAD_SCORE)
        top_i = torch.nn.functional.pad(top_i, (0, k - k_eff), value=-1)
    return top_s, top_i.to(torch.int32)


class IVFIndex:
    def __init__(
        self,
        dim: int,
        n_cells: int = 100,
        nprobe: int = 8,
        metric: str = "l2",
        cell_cap: Optional[int] = None,
        seed: int = 0,
        target_recall: Optional[float] = None,
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        """target_recall: build() calibrates the smallest nprobe whose
        measured Recall@10 clears it on this corpus (`calibrate_nprobe`;
        the verdict is `self.calibration`). device: None is the card
        (raises without CUDA); "cpu" asks for the CPU. mesh: shard the cells
        over the mesh's corpus axis (its first device is the index's)."""
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(metric)
        self.mesh = check_mesh(mesh)
        if mesh is not None:
            device = mesh.device
        self.dim = dim
        self.n_cells = n_cells
        self.nprobe = min(nprobe, n_cells)
        self.metric = metric
        self.cell_cap = cell_cap
        self.seed = seed
        self.target_recall = target_recall
        self.device = resolve_device(device)
        self.calibration: Optional[dict] = None
        self.centroids: Optional[torch.Tensor] = None
        self._cells: Optional[torch.Tensor] = None      # (C, cap, d)
        self._cell_ids: Optional[torch.Tensor] = None   # (C, cap) int32, -1 pad
        self._cell_sq: Optional[torch.Tensor] = None    # (C, cap) row sqnorms
        self._overflow: Optional[torch.Tensor] = None   # (O, d)
        self._overflow_ids: Optional[torch.Tensor] = None
        self._overflow_sq: Optional[torch.Tensor] = None
        self._row_loc: Optional[np.ndarray] = None      # row -> storage slot
        self._sharded = None  # mesh: per-shard storage (shard_ivf)
        self._ntotal = 0

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if self.metric == "cosine":
            vectors = vectors / np.maximum(
                np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12
            )
        return vectors

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(
            self.device)

    def build(self, vectors: np.ndarray, train_iters: int = 10) -> "IVFIndex":
        """Train centroids and populate cells in one pass."""
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        n_cells = min(self.n_cells, n)
        self.n_cells = n_cells
        self.nprobe = min(self.nprobe, n_cells)
        self.centroids, assign = _kmeans_assign(
            self._to_device(vectors), n_cells, train_iters, self.seed
        )
        self._populate(vectors, assign.cpu().numpy())
        if self.target_recall is not None:
            self.calibrate_nprobe(self.target_recall, vectors)
        return self

    def calibrate_nprobe(
        self,
        target_recall: float,
        vectors: np.ndarray,
        k: int = 10,
        n_sample: int = 256,
        query_chunk: int = 16,
    ) -> dict:
        """Pick the smallest nprobe whose sampled Recall@k clears
        `target_recall` on this corpus. Sample queries are perturbed corpus
        rows; the truth is the exact flat ranking of the same rows. Doubles
        nprobe from 1, then bisects twice between the last failing and the
        passing value. Sets self.nprobe and records {target, achieved,
        nprobe, k, curve} in self.calibration."""
        rng = np.random.default_rng(self.seed + 1)
        vectors = self._prep(vectors)
        n = vectors.shape[0]
        q = vectors[rng.integers(0, n, min(n_sample, n))]
        q = q + 0.1 * q.std() * rng.standard_normal(q.shape).astype(
            np.float32
        )
        if self.metric == "cosine":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-12
            )
        metric = "l2" if self.metric == "l2" else "dot"
        _, want = flat_topk_ref(
            self._to_device(q), self._to_device(vectors), k, metric=metric
        )
        want = want.cpu().numpy()
        kk = want.shape[1]

        def measure(p_eff):
            _, got = self.search(q, kk, nprobe=p_eff, query_chunk=query_chunk)
            got = got.cpu().numpy()
            return float(np.mean([
                len(set(got[i]) & set(want[i])) / kk
                for i in range(len(q))
            ]))

        curve = []
        p = 1
        while True:
            p_eff = min(p, self.n_cells)
            r = measure(p_eff)
            curve.append((p_eff, round(r, 4)))
            if r >= target_recall or p_eff == self.n_cells:
                nprobe, achieved = p_eff, r
                break
            p *= 2
        # two midpoints between the last failing power of two and the
        # passing one bound the overshoot to ~25%; none when the target was
        # never met (recall is monotone in nprobe)
        lo = curve[-2][0] if len(curve) >= 2 else 0
        if achieved < target_recall:
            lo = nprobe
        for _ in range(2):
            if nprobe - lo <= max(1, nprobe // 8):
                break
            mid = (lo + nprobe) // 2
            r_mid = measure(mid)
            curve.append((mid, round(r_mid, 4)))
            if r_mid >= target_recall:
                nprobe, achieved = mid, r_mid
            else:
                lo = mid
        self.nprobe = nprobe
        self.calibration = {
            "target": target_recall,
            "achieved": round(achieved, 4),
            "nprobe": nprobe,
            "k": kk,
            "curve": curve,
        }
        return self.calibration

    def _auto_cap(self, counts: np.ndarray) -> int:
        """Cost-optimal cell capacity: the cap minimizing nprobe*cap +
        sum(max(0, count - cap)) over the observed occupancies (a probe
        scans nprobe padded cells plus the overflow block)."""
        cands = np.unique(counts[counts > 0])
        if cands.size == 0:
            return 1
        overflow = np.maximum(
            0, counts[None, :] - cands[:, None]
        ).sum(axis=1)
        cost = self.nprobe * cands + overflow
        return max(1, int(cands[int(np.argmin(cost))]))

    def _populate(self, vectors: np.ndarray, assign: np.ndarray) -> None:
        """Fill capacity-padded cells (+ overflow block) from a per-row cell
        assignment. Needs self.centroids and n_cells set. A stable sort by
        cell keeps rows ascending within each cell, the slot order of
        sequential insertion."""
        n = vectors.shape[0]
        self._ntotal = n
        n_cells = self.n_cells
        counts = np.bincount(assign, minlength=n_cells)
        cap = self.cell_cap or self._auto_cap(counts)
        cells = np.zeros((n_cells, cap, self.dim), np.float32)
        cell_ids = np.full((n_cells, cap), -1, np.int32)
        order = np.argsort(assign, kind="stable").astype(np.int64)
        sorted_cell = assign[order]
        starts = np.searchsorted(sorted_cell, np.arange(n_cells))
        slot = np.arange(n, dtype=np.int64) - starts[sorted_cell]
        in_cap = slot < cap
        cells[sorted_cell[in_cap], slot[in_cap]] = vectors[order[in_cap]]
        cell_ids[sorted_cell[in_cap], slot[in_cap]] = order[in_cap]
        ovf = np.sort(order[~in_cap])  # row order, as sequential append
        self._set_storage(
            cells, cell_ids,
            vectors[ovf] if ovf.size else None,
            ovf.astype(np.int32) if ovf.size else None,
        )

    def _set_storage(self, cells, cell_ids, overflow, overflow_ids) -> None:
        """Move the cells (and overflow block) to the device with the row
        sqnorms the l2 scan reads."""
        self._cells = self._to_device(cells)
        self._cell_ids = self._to_device(cell_ids)
        self._cell_sq = torch.sum(self._cells * self._cells, dim=-1)
        if overflow is not None:
            self._overflow = self._to_device(overflow)
            self._overflow_ids = self._to_device(overflow_ids)
            self._overflow_sq = torch.sum(
                self._overflow * self._overflow, dim=-1)
        else:
            self._overflow = self._overflow_ids = self._overflow_sq = None
        self._row_loc = None  # rebuilt lazily by rows()
        self._sharded = None
        if self.mesh is not None:
            from persian_rag_tpu_torch.parallel.sharded_ivf import shard_ivf

            self._sharded = shard_ivf(
                self.centroids.cpu().numpy(), cells, cell_ids, overflow,
                overflow_ids, self.mesh, self.dim)

    def _build_row_loc(self) -> None:
        """Host map: row id -> flat storage slot; slots [0, C*cap) index
        cells.reshape(C*cap, d), slots >= C*cap the overflow block."""
        cell_ids = self._cell_ids.cpu().numpy()
        flat_ids = cell_ids.reshape(-1)
        loc = np.full(self._ntotal, -1, np.int64)
        valid = flat_ids >= 0
        loc[flat_ids[valid]] = np.nonzero(valid)[0]
        if self._overflow_ids is not None:
            o_ids = self._overflow_ids.cpu().numpy()
            loc[o_ids] = cell_ids.size + np.arange(o_ids.shape[0])
        self._row_loc = loc

    def rows(self, row_ids) -> np.ndarray:
        """f32 host copies of the given rows by at most two device gathers
        (cells, overflow); the stored form, so normalized for cosine."""
        if self._cells is None:
            raise ValueError("index not built")
        if self._row_loc is None:
            self._build_row_loc()
        idx = np.asarray(row_ids, np.int64)
        loc = self._row_loc[idx]
        n_cell_slots = int(self._cell_ids.numel())
        out = np.zeros((idx.shape[0], self.dim), np.float32)
        in_cells = (loc >= 0) & (loc < n_cell_slots)
        if in_cells.any():
            flat = self._cells.reshape(-1, self.dim)
            out[in_cells] = flat[self._to_device(loc[in_cells])].cpu().numpy()
        in_ovf = loc >= n_cell_slots
        if in_ovf.any():
            out[in_ovf] = self._overflow[
                self._to_device(loc[in_ovf] - n_cell_slots)].cpu().numpy()
        return out

    # -- FAISS IVF file interop ------------------------------------------------

    @classmethod
    def from_faiss(
        cls, path: str, nprobe: Optional[int] = None, device=None, mesh=None
    ) -> "IVFIndex":
        """Import a FAISS IndexIVFFlat file: centroids and cell assignments
        come from the file, no retraining."""
        device = mesh.device if mesh is not None else resolve_device(device)
        data = faiss_io.read_faiss_ivf(path)
        index = cls(
            data["vectors"].shape[1],
            n_cells=data["centroids"].shape[0],
            nprobe=nprobe or max(1, data["nprobe"]),
            metric=data["metric"],
            device=device,
            mesh=mesh,
        )
        index.centroids = index._to_device(data["centroids"])
        index._populate(data["vectors"], data["assign"])
        return index

    def export_faiss(self, path: str, nprobe: Optional[int] = None) -> None:
        """Write a faiss-loadable IndexIVFFlat file. Overflow rows go to
        their nearest centroid (their natural cell)."""
        if self._cells is None:
            raise ValueError("index not built")
        vectors = np.zeros((self._ntotal, self.dim), np.float32)
        assign = np.full(self._ntotal, -1, np.int32)
        cells = self._cells.cpu().numpy()
        cell_ids = self._cell_ids.cpu().numpy()
        for cell in range(self.n_cells):
            mask = cell_ids[cell] >= 0
            ids = cell_ids[cell][mask]
            vectors[ids] = cells[cell][mask]
            assign[ids] = cell
        if self._overflow is not None:
            o_ids = self._overflow_ids.cpu().numpy()
            _, o_assign = flat_topk_ref(
                self._overflow, self.centroids, 1, metric="l2")
            vectors[o_ids] = self._overflow.cpu().numpy()
            assign[o_ids] = o_assign[:, 0].cpu().numpy()
        metric = "l2" if self.metric == "l2" else "ip"
        faiss_io.write_faiss_ivf(
            path,
            vectors,
            self.centroids.cpu().numpy(),
            assign,
            metric=metric,
            nprobe=nprobe or self.nprobe,
        )

    # -- search ----------------------------------------------------------------

    def search(
        self,
        queries,
        k: int,
        nprobe: Optional[int] = None,
        query_chunk: int = 16,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host or device queries -> (scores, int32 ids) tensors on the
        index's device, each (Q, k), like DenseIndex.search: l2 squared
        distances ascending, ip / cosine scores descending. Pads: id -1."""
        if isinstance(queries, torch.Tensor):
            q = queries.reshape(-1, self.dim).to(self.device)
            return self.search_device(q, k, nprobe, query_chunk)
        q = self._prep(np.atleast_2d(np.asarray(queries, np.float32)))
        return self._search(self._to_device(q), k, nprobe, query_chunk)

    def search_device(
        self,
        queries: torch.Tensor,
        k: int,
        nprobe: Optional[int] = None,
        query_chunk: int = 16,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, d) device queries -> (scores, ids) device tensors (cosine
        normalizes the queries here)."""
        q = queries.float()
        if self.metric == "cosine":
            norms = torch.linalg.norm(q, dim=1, keepdim=True)
            q = q / torch.clamp(norms, min=1e-12)
        return self._search(q, k, nprobe, query_chunk)

    def _search(self, q, k, nprobe, query_chunk):
        if self._cells is None:
            raise ValueError("index not built")
        nprobe = min(nprobe or self.nprobe, self.n_cells)
        k = min(k, self._ntotal)
        metric = "l2" if self.metric == "l2" else "dot"
        if self._sharded is not None:
            from persian_rag_tpu_torch.parallel.sharded_ivf import (
                sharded_ivf_topk,
            )

            return sharded_ivf_topk(q, self._sharded, k, nprobe, metric,
                                    self.mesh)
        chunk = max(1, min(query_chunk, q.shape[0]))
        parts = [
            _ivf_search_step(
                q[start : start + chunk], self.centroids, self._cells,
                self._cell_ids, self._cell_sq, self._overflow,
                self._overflow_ids, self._overflow_sq,
                k=k, nprobe=nprobe, metric=metric,
            )
            for start in range(0, q.shape[0], chunk)
        ]
        scores = torch.cat([s for s, _ in parts])
        ids = torch.cat([i for _, i in parts])
        if self.metric == "l2":
            scores = -scores  # back to squared distances ascending
        return scores, ids

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """.npz payload + .meta.json sidecar, the JAX package's format."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {
            "centroids": self.centroids.cpu().numpy(),
            "cells": self._cells.cpu().numpy(),
            "cell_ids": self._cell_ids.cpu().numpy(),
        }
        if self._overflow is not None:
            arrays["overflow"] = self._overflow.cpu().numpy()
            arrays["overflow_ids"] = self._overflow_ids.cpu().numpy()
        np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(
                {
                    "dim": self.dim,
                    "n_cells": self.n_cells,
                    "nprobe": self.nprobe,
                    "metric": self.metric,
                    "ntotal": self._ntotal,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device=None, mesh=None) -> "IVFIndex":
        device = mesh.device if mesh is not None else resolve_device(device)
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".meta.json", encoding="utf-8") as f:
            meta = json.load(f)
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        index = cls(
            meta["dim"],
            n_cells=meta["n_cells"],
            nprobe=meta["nprobe"],
            metric=meta["metric"],
            device=device,
            mesh=mesh,
        )
        index.centroids = index._to_device(data["centroids"])
        has_overflow = "overflow" in data
        index._set_storage(
            data["cells"], data["cell_ids"],
            data["overflow"] if has_overflow else None,
            data["overflow_ids"] if has_overflow else None,
        )
        index._ntotal = meta["ntotal"]
        return index
