"""Corpus-sharded flat search.

The counterpart of ``persian_rag_tpu.parallel.sharded_search``. The rows
of a corpus shard over the mesh's ``corpus`` axis, and

  1. each shard runs the port's own `flat_topk` over its local rows (on
     the card: the kernels a corpus of that size would launch alone),
  2. local indices are offset to global ids (``shard * local_n``),
  3. each shard's (Q, k) candidates are copied to the mesh's first device
     (the all_gather), and
  4. one merge there picks the global top-k.

Exactness: the global top-k of a union of per-shard top-k sets is the
global top-k of all rows, so the ids equal a single-device scan's.

Pad rows (to a shard multiple) compete inside a shard's LOCAL top-k
before they are masked (id -1 at NEG_INF, or +3e38 for l2), so every
shard over-retrieves by the static pad count: at most that many local
slots hold pads, and each shard still surfaces its k best real rows.

The merge is a stable sort of the shard-major concatenation: on equal
scores the earlier shard, and within a shard the lower row, comes first,
which is the lower global id, the order ``jax.lax.top_k`` gives there
(``torch.topk`` leaves ties unordered).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from persian_rag_tpu_torch.core.mesh import (
    CORPUS_AXIS,
    DATA_AXIS,
    Mesh,
    corpus_sharding,
    pad_rows,
    pad_to_multiple,
)
from persian_rag_tpu_torch.ops.flat_topk import (
    NEG_INF,
    flat_topk,
    flat_topk_scaled_candidates,
)

# an int8 shard of at least this many rows takes the merge-free candidate
# pass (#4), as the JAX sharded int8 tier does on the TPU
INT8_CANDIDATES_MIN_N = 4096

Shards = List[List[torch.Tensor]]


def shard_rows(x: torch.Tensor, mesh: Mesh, value=0) -> Tuple[Shards, int]:
    """Pad x's rows to a multiple of the corpus axis (at least one row a
    shard) with `value` and place them row-sharded: (shards, original
    rows). ``shards[i][j]`` is shard i on ``mesh.devices[i][j]``."""
    n = x.shape[0]
    n_pad = pad_to_multiple(max(n, mesh.shape[CORPUS_AXIS]),
                            mesh.shape[CORPUS_AXIS])
    return corpus_sharding(pad_rows(x, n_pad, value), mesh), n


def shard_corpus(corpus: torch.Tensor, mesh: Mesh) -> Tuple[Shards, int]:
    """Pad an (N, d) corpus with zero rows to a shard multiple and place it
    row-sharded. Returns (shards, original N); `sharded_flat_topk` masks
    the pad rows out of its results."""
    return shard_rows(corpus, mesh)


def _to(t: Optional[torch.Tensor], dev: torch.device):
    return None if t is None else t.to(dev, non_blocking=True)


def _local(shards: Optional[Shards], i: int, j: int = 0):
    return None if shards is None else shards[i][j]


def mask_pads(s: torch.Tensor, gid: torch.Tensor, n_actual: int,
              descending: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad rows (global id >= n_actual) and empty slots (id < 0) -> id -1
    at the worst score (NEG_INF, or -NEG_INF for an ascending list)."""
    invalid = (gid >= n_actual) | (gid < 0)
    worst = NEG_INF if descending else -NEG_INF
    return (torch.where(invalid, torch.full_like(s, worst), s),
            torch.where(invalid, torch.full_like(gid, -1), gid))


def merge_topk(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int,
               device: torch.device, descending: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The all_gather and the merge: each (Q, k_i) (scores, global ids)
    part copied to `device`, concatenated in part order, and cut to the
    top k by a stable sort (earlier part, then lower position, on ties)."""
    cand_s = torch.cat([s.to(device, non_blocking=True) for s, _ in parts], 1)
    cand_i = torch.cat([i.to(device, non_blocking=True).long()
                        for _, i in parts], 1)
    top_s, pos = torch.sort(cand_s, dim=1, descending=descending,
                            stable=True)
    k = min(k, cand_s.shape[1])
    return top_s[:, :k], torch.gather(cand_i, 1, pos[:, :k])


def merge_by_score_id(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of (Q, C) candidates by (score descending, id ascending): the
    JAX package's two-key ``lax.sort``, as a stable sort by id and then a
    stable sort by score."""
    by_id = torch.argsort(cand_i, dim=1, stable=True)
    cand_s = torch.gather(cand_s, 1, by_id)
    cand_i = torch.gather(cand_i, 1, by_id)
    top_s, by_s = torch.sort(cand_s, dim=1, descending=True, stable=True)
    k = min(k, cand_s.shape[1])
    return top_s[:, :k], torch.gather(cand_i, 1, by_s[:, :k])


def _local_k(shards: Shards, k: int, n_actual: int) -> Tuple[int, int]:
    """(k clamped to N, the local over-retrieve k + pad count)."""
    n_shards = len(shards)
    local_n = shards[0][0].shape[0]
    k = min(k, n_actual)
    pad_total = local_n * n_shards - n_actual
    return k, min(k + pad_total, local_n)


def _shard_search(q, i, j, corpus_shards, k_local, metric, compute_dtype,
                  mode, sq, c16, center, sqmax, lo):
    """One shard's local top-k on its device: (scores, local ids)."""
    c = corpus_shards[i][j]
    dev = c.device
    return flat_topk(
        q.to(dev, non_blocking=True), c, k_local, metric=metric,
        corpus_sqnorm=_local(sq, i, j), corpus_bf16=_local(c16, i, j),
        compute_dtype=compute_dtype, mode=mode,
        corpus_center=_to(center, dev), center_sqmax=_to(sqmax, dev),
        corpus_bf16_lo=_local(lo, i, j),
    )


def sharded_flat_topk(
    queries: torch.Tensor,
    corpus_sharded: Shards,
    k: int,
    n_actual: int,
    mesh: Mesh,
    metric: str = "dot",
    compute_dtype=torch.float32,
    mode: str = "exact",
    corpus_sqnorm_sharded: Optional[Shards] = None,
    corpus_bf16_sharded: Optional[Shards] = None,
    corpus_center: Optional[torch.Tensor] = None,
    center_sqmax: Optional[torch.Tensor] = None,
    corpus_bf16_lo_sharded: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a row-sharded corpus; ids equal a single-device scan's.

    Returns ((Q, k) scores, (Q, k) global ids) on the mesh's first device;
    l2 scores are squared distances ascending. The serving caches (row
    sqnorms, the centered bf16 stage-1 image and its lo residues) come in
    the corpus's own sharding, so each shard's `flat_topk` reads its
    slice. As in the JAX package, no proof verdict feeds the runtime
    demotion on a mesh."""
    k, k_local = _local_k(corpus_sharded, k, n_actual)
    descending = metric != "l2"
    local_n = corpus_sharded[0][0].shape[0]
    parts = []
    for i in range(len(corpus_sharded)):
        s, idx = _shard_search(
            queries, i, 0, corpus_sharded, k_local, metric, compute_dtype,
            mode, corpus_sqnorm_sharded, corpus_bf16_sharded, corpus_center,
            center_sqmax, corpus_bf16_lo_sharded)
        parts.append(mask_pads(s, idx.long() + i * local_n, n_actual,
                               descending))
    return merge_topk(parts, k, mesh.device, descending)


def sharded_flat_topk_2d(
    queries: torch.Tensor,
    corpus_sharded: Shards,
    k: int,
    n_actual: int,
    mesh: Mesh,
    metric: str = "dot",
    compute_dtype=torch.float32,
    mode: str = "exact",
    corpus_sqnorm_sharded: Optional[Shards] = None,
    corpus_bf16_sharded: Optional[Shards] = None,
    corpus_center: Optional[torch.Tensor] = None,
    center_sqmax: Optional[torch.Tensor] = None,
    corpus_bf16_lo_sharded: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D search: queries split over the ``data`` axis (padded with zero
    rows to a multiple of it) while the corpus shards over ``corpus``.
    Device (i, j) scans corpus shard i for query slice j; each slice's
    candidates merge over the corpus axis only. The results come back to
    the mesh's first device in query order (JAX keeps them data-sharded;
    the values are the same)."""
    n_q = queries.shape[0]
    dp = mesh.shape[DATA_AXIS]
    q_pad = pad_to_multiple(max(n_q, dp), dp)
    queries = pad_rows(queries, q_pad)
    k, k_local = _local_k(corpus_sharded, k, n_actual)
    descending = metric != "l2"
    local_n = corpus_sharded[0][0].shape[0]
    out_s, out_i = [], []
    for j, q in enumerate(torch.chunk(queries, dp)):
        parts = []
        for i in range(len(corpus_sharded)):
            s, idx = _shard_search(
                q, i, j, corpus_sharded, k_local, metric, compute_dtype,
                mode, corpus_sqnorm_sharded, corpus_bf16_sharded,
                corpus_center, center_sqmax, corpus_bf16_lo_sharded)
            parts.append(mask_pads(s, idx.long() + i * local_n, n_actual,
                                   descending))
        s, i_ = merge_topk(parts, k, mesh.device, descending)
        out_s.append(s)
        out_i.append(i_)
    return torch.cat(out_s)[:n_q], torch.cat(out_i)[:n_q]


def sharded_int8_topk(
    queries: torch.Tensor,
    values_sharded: Shards,
    scales_sharded: Shards,
    refine_sharded: Shards,
    k: int,
    n_actual: int,
    mesh: Mesh,
    k_scan: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded int8 candidate tier with a per-shard exact refine and a
    merged global top-k (dot / cosine, as the single-device int8 tier).

    Each shard takes k_scan candidates from its LOCAL int8 rows (the
    merge-free row-scaled candidate pass, #4 on the card, at
    INT8_CANDIDATES_MIN_N rows and more; else the exact int8-score
    top-k), re-scores them against its refine rows (`_refine_topk`) and
    contributes its refined local top-k to the merge. The union of the
    shards' candidate sets holds the global int8 top-k_scan, so recall is
    at least the single-device tier's."""
    from persian_rag_tpu_torch.index.dense import _refine_topk

    k, k_local = _local_k(values_sharded, k, n_actual)
    local_n = values_sharded[0][0].shape[0]
    k_scan_local = min(max(k_scan, k_local), local_n)
    parts = []
    for i in range(len(values_sharded)):
        v = values_sharded[i][0]
        q = queries.to(v.device, non_blocking=True)
        if local_n >= INT8_CANDIDATES_MIN_N:
            cand = flat_topk_scaled_candidates(
                q, v, scales_sharded[i][0], k_scan_local)
        else:
            _, cand = flat_topk(q, v, k_scan_local, metric="dot",
                                corpus_scale=scales_sharded[i][0])
        s, idx = _refine_topk(q, refine_sharded[i][0], cand, k_local)
        idx = idx.long()
        gid = torch.where(idx >= 0, idx + i * local_n, idx)
        parts.append(mask_pads(s, gid, n_actual))
    return merge_topk(parts, k, mesh.device)
