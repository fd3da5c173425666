"""Lexical top-k through a hashed upper-bound prefilter, then an exact
rescore.

The counterpart of ``persian_rag_tpu.ops.lexical_prefilter``. At build time
every document becomes a dense H-wide "impact" row

    W[d, h] = sum over the terms t of d with bucket(t) = h of w(t, d),

w(t, d) >= 0 its stored BM25 / TF-IDF contribution; the most frequent terms
get buckets of their own, the rest are hashed. A query becomes q[h], the
sum of its term weights per bucket. With every weight nonnegative,
q . W[d] >= the document's true score (a collision only adds), and W is
kept in bf16 rounded toward +inf, so the bf16 image bounds it too.

Stage 1 is the dense candidate kernel (#1, ``ops.flat_topk.
flat_topk_candidates`` over the (N, H) bf16 image, d = H): each tile's top
n_easy keys and the bound of the rest. The top k_scan candidates are
gathered from the ELL and rescored exactly (``ops.sparse_scores.
rescore_ell``), and the residual proof holds every other document below

    bump(value(bound key)) + eps,  eps = eps_bf16(H) ||q|| max_d ||W16[d]||

with 2^-16 of relative slack for the f32 order of the full scan. Where the
k-th rescored score clears it for every query, the top k equals the full
scan's; otherwise ("verified") the batch reruns on the ELL scan
(``sparse_topk``), or ("fast", ``fallback=False``) the rescored candidates
are served as they are: exact scores, candidate recall unguarded.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.ops.flat_topk import (
    _COL_MASK,
    _bf16_matmul_eps,
    _candidate_ids,
    _ikey_to_score,
    _topk_desc,
    flat_topk_candidates,
)
from persian_rag_tpu_torch.ops.sparse_scores import rescore_ell, sparse_topk

# Knuth's multiplicative hash constant: vocabulary ids are dense 0..V-1, so
# a plain modulo would alias them systematically
_HASH_MULT = 2654435761


def assign_buckets(df: np.ndarray, n_buckets: int,
                   dedicated_frac: float = 0.5) -> np.ndarray:
    """(V,) int32 term -> bucket map: the n_buckets * dedicated_frac terms
    of highest document frequency (stable order) get buckets of their own,
    the rest are hashed into the others."""
    v = int(df.shape[0])
    n_ded = min(v, int(n_buckets * dedicated_frac))
    out = np.empty(v, np.int32)
    if n_ded:
        top = np.argsort(-df.astype(np.int64), kind="stable")[:n_ded]
        out[:] = -1
        out[top] = np.arange(n_ded, dtype=np.int32)
        rest = out < 0
    else:
        rest = np.ones(v, bool)
    n_hash = max(1, n_buckets - n_ded)
    tids = np.nonzero(rest)[0].astype(np.uint64)
    out[rest] = (
        ((tids * _HASH_MULT) & 0xFFFFFFFF) % n_hash + n_ded
    ).astype(np.int32)
    return out


def _bf16_round_up(x: np.ndarray) -> np.ndarray:
    """Nonnegative f32 values rounded up to the next bf16 value (toward
    +inf), on their bits: the high 16 bits, plus one unit of the 16th where
    any low bit is set (a carry into the exponent is still the next bf16
    value for a positive float)."""
    u = x.astype(np.float32).view(np.uint32)
    inc = ((u & 0xFFFF) != 0).astype(np.uint32)
    return ((u & np.uint32(0xFFFF0000)) + (inc << 16)).view(np.float32)


def build_ub_image(ell_ids: np.ndarray, ell_vals: np.ndarray,
                   term_map: np.ndarray, n_buckets: int,
                   chunk_rows: int = 65536) -> Tuple[np.ndarray, float]:
    """The (N, H) bf16 round-up impact image of a padded ELL (as f32 values
    that are exact bf16 values) and its largest row l2 norm. Bucket sums
    are taken in float64 (np.bincount) chunk by chunk, as the JAX
    package's."""
    n, _ = ell_ids.shape
    h = n_buckets
    w = np.zeros((n, h), np.float32)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        ids = ell_ids[lo:hi]
        vals = ell_vals[lo:hi]
        mask = ids >= 0
        rows = np.nonzero(mask)[0]
        flat = rows.astype(np.int64) * h + term_map[ids[mask]]
        w[lo:hi] = np.bincount(
            flat, weights=vals[mask].astype(np.float64),
            minlength=(hi - lo) * h,
        ).reshape(hi - lo, h)
    w16 = _bf16_round_up(w)
    row_norm_max = float(
        np.sqrt(np.max(np.sum(w16.astype(np.float64) ** 2, axis=1))))
    return w16, row_norm_max


def hash_queries(qids: np.ndarray, qvals: np.ndarray, term_map: np.ndarray,
                 n_buckets: int) -> np.ndarray:
    """(B, H) f32 bucket sums of the query weights (host side)."""
    out = np.zeros((qids.shape[0], n_buckets), np.float32)
    mask = qids >= 0
    rows = np.nonzero(mask)[0]
    np.add.at(out, (rows, term_map[qids[mask]]), qvals[mask])
    return out


def prefilter_tile_n(n_docs: int) -> int:
    """Stage 1's corpus tile: the JAX package's two-stage policy
    (`two_stage_tiles`: 1,024 rows below 150,000 documents, 2,048 from
    there), clamped to the corpus by `flat_topk_candidates`."""
    return 1024 if n_docs < 150_000 else 2048


def prefilter_topk(
    q_hash: torch.Tensor,
    w16: torch.Tensor,
    row_norm_max: float,
    ell_ids: torch.Tensor,
    ell_vals: torch.Tensor,
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
    k: int,
    k_scan: int = 256,
    n_easy: int = 4,
    return_ok: bool = False,
    tile_n: int = 0,
    fallback: bool = True,
):
    """Lexical top-k through the hashed-UB prefilter: stage 1 over the
    bf16 image, the top k_scan candidate keys (a stable sort), the exact
    rescore of their rows, the residual proof, and (fallback=True) the
    full ELL scan for the batch when any query's proof fails (one host read
    of all(ok)). Returns (scores (B, k) f32, ids (B, k) int32[, ok (B,)]).
    A grid of fewer than k candidates serves the scan directly."""
    b = q_hash.shape[0]
    cand_keys, bound_keys, tn = flat_topk_candidates(
        q_hash.float(), w16, metric="dot",
        tile_n=tile_n or prefilter_tile_n(ell_ids.shape[0]), n_easy=n_easy)
    if cand_keys.shape[1] < k:
        out = sparse_topk(ell_ids, ell_vals, q_ids, q_vals, k)
        if return_ok:
            return out + (torch.zeros(b, dtype=torch.bool,
                                      device=q_hash.device),)
        return out
    k_scan = max(min(k_scan, cand_keys.shape[1]), k)
    top_keys, ids = _candidate_ids(cand_keys, k_scan, tn, n_easy)
    # every non-candidate's image score lies at or below this key's value
    bound_key = torch.maximum(bound_keys.max(dim=1).values,
                              top_keys[:, k_scan - 1])
    bound_val = _ikey_to_score(bound_key & ~_COL_MASK)
    bound_val = bound_val + bound_val.abs() * 2.0 ** -11
    qn = torch.sqrt(torch.sum(q_hash.float() ** 2, dim=-1))
    eps = _bf16_matmul_eps(w16.shape[1]) * qn * float(np.float32(row_norm_max))
    # candidates ascending (pads first): the stable sort keeps the scan's
    # lower-id-first tie order
    cand = torch.sort(ids, dim=1).values
    scores = rescore_ell(ell_ids, ell_vals, q_ids, q_vals, cand)
    top_s, pos = _topk_desc(scores, k)
    top_i = torch.gather(cand, 1, pos).int()
    outside = (bound_val + eps) * (1.0 + 2.0 ** -16)
    ok = top_s[:, k - 1] > outside
    if fallback and not bool(ok.all()):
        top_s, top_i = sparse_topk(ell_ids, ell_vals, q_ids, q_vals, k)
    if return_ok:
        return top_s, top_i, ok
    return top_s, top_i
