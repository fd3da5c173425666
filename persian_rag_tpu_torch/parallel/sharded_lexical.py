"""Corpus-sharded lexical (BM25 / TF-IDF) search.

The counterpart of ``persian_rag_tpu.parallel.sharded_lexical``, shaped
like the dense sharded search: ELL document rows shard over the mesh's
corpus axis, each shard runs a sparse top-k kernel over its rows, local
ids are offset to global ones and the per-shard candidates merge on the
mesh's first device. Scoring constants (idf, normalisation) were fixed at
build time over the whole corpus, so the sharded lists equal the
single-device ones.

Each shard's device layout is the one the single-device gates pick for
its rows (``index.lexical._EllIndex._device_ell``): a shard reaches the
flat (#10), hashed (#11), union (#12) or hashed-union (#13) kernel as a
corpus of its size would. The JAX mesh path keeps every shard flat; the
lists are the same.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.core.mesh import CORPUS_AXIS, Mesh, pad_to_multiple
from persian_rag_tpu_torch.parallel.sharded_search import mask_pads, merge_topk

# the union kernels' merge serves local over-retrieves up to this k (the
# JAX gate: wider ones keep the per-term kernels)
UNION_MAX_K = 32


def shard_ell(doc_ids: np.ndarray, doc_vals: np.ndarray, mesh: Mesh
              ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Pad host ELL arrays to a shard multiple (pad rows: ids -1, values
    0) and split them over the corpus axis: ([(ids, vals) per shard],
    original N). The caller places each shard on its device."""
    n = doc_ids.shape[0]
    n_shards = mesh.shape[CORPUS_AXIS]
    n_pad = pad_to_multiple(max(n, n_shards), n_shards)
    if n_pad != n:
        doc_ids = np.concatenate([doc_ids, np.full(
            (n_pad - n,) + doc_ids.shape[1:], -1, doc_ids.dtype)])
        doc_vals = np.concatenate([doc_vals, np.zeros(
            (n_pad - n,) + doc_vals.shape[1:], doc_vals.dtype)])
    local = n_pad // n_shards
    return [(doc_ids[i * local:(i + 1) * local],
             doc_vals[i * local:(i + 1) * local])
            for i in range(n_shards)], n


def sharded_sparse_topk(
    shards: Sequence[Tuple],
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
    k: int,
    n_actual: int,
    mesh: Mesh,
    use_union: bool = False,
    hash_ok: Optional[Sequence[bool]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, k) scores descending, (B, k) global ids) on the mesh's first
    device.

    shards: per corpus shard, its device layout (ids, vals, ids3, vals3) as
    ``_EllIndex._device_ell`` builds it. ELL pad documents score 0.0 in a
    LOCAL top-k and can displace real documents whose contribution is
    negative, so each shard over-retrieves by the static pad count. The
    union kernels serve a shard only while that local k is at most
    UNION_MAX_K (the JAX gate); hash_ok[i] is the batch's hashed-union
    work verdict for shard i."""
    from persian_rag_tpu_torch.index.lexical import _topk_one_layout

    local_n = shards[0][0].shape[0]
    k = min(k, n_actual)
    pad_total = local_n * len(shards) - n_actual
    k_local = min(k + pad_total, local_n)
    use_union = use_union and k_local <= UNION_MAX_K
    parts = []
    for i, (ids, vals, ids3, vals3) in enumerate(shards):
        dev = ids.device
        s, idx = _topk_one_layout(
            ids, vals, ids3, vals3, q_ids.to(dev, non_blocking=True),
            q_vals.to(dev, non_blocking=True), k_local, use_union,
            True if hash_ok is None else hash_ok[i])
        idx = idx.long()
        gid = torch.where(idx >= 0, idx + i * local_n, idx)
        parts.append(mask_pads(s, gid, n_actual))
    return merge_topk(parts, k, mesh.device)
