"""Device-side hybrid score fusion (+ optional stored-vector rerank).

The counterpart of ``persian_rag_tpu.ops.hybrid_fusion``: the reference's
hybrid semantics (each channel retrieves 2k candidates, scores are
max-normalised per channel, summed with 0.6/0.4 weights, deduplicated by
id and re-sorted) as tensor math on the index's device, so that the
hybrid chain ends in one host copy instead of a per-query Python loop.

Tie and dedup order equal the host loop's:

* candidates are laid out [dense slots in rank order, BM25 slots in rank
  order], as the host dict inserts them;
* a BM25 slot whose id is already in the dense list is masked out (the
  dense occurrence carries both contributions);
* a stable sort keeps that order among equal fused scores, as Python's
  stable sort does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from persian_rag_tpu_torch.ops.flat_topk import NEG_INF, full_f32


def _channel_norm(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-query max-normalisation with the reference's zero guard
    (`s / max if max > 0 else 0.0`)."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    mx = torch.max(masked, dim=1, keepdim=True).values
    pos = mx > 0
    return torch.where(
        valid & pos, scores / torch.where(pos, mx, torch.ones_like(mx)),
        torch.zeros_like(scores),
    )


def _stable_desc(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def fuse_hybrid(
    dense_scores: torch.Tensor,
    dense_ids: torch.Tensor,
    lex_scores: torch.Tensor,
    lex_ids: torch.Tensor,
    k: int,
    dense_weight: float = 0.6,
    bm25_weight: float = 0.4,
    dense_sim: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse per-channel top-m results into hybrid top-k.

    dense_scores/dense_ids (Q, m_d): the dense channel in rank order; for
    dense_sim="l2" the scores are squared distances, mapped by 1/(1+d2),
    otherwise similarities as they are. lex_scores/lex_ids (Q, m_b): the
    BM25 channel, score descending. Ids < 0 are empty slots.

    Returns (fused scores (Q, k'), ids (Q, k')), k' = min(k, m_d + m_b);
    empty slots carry id -1 and score NEG_INF."""
    d_valid = dense_ids >= 0
    b_valid = lex_ids >= 0
    d_sim = 1.0 / (1.0 + dense_scores) if dense_sim == "l2" else dense_scores
    d_norm = _channel_norm(d_sim.float(), d_valid) * dense_weight
    b_norm = _channel_norm(lex_scores.float(), b_valid) * bm25_weight

    # cross-channel contribution lookup by id equality: (Q, m_d, m_b)
    match = dense_ids[:, :, None].long() == lex_ids[:, None, :].long()
    match = match & d_valid[:, :, None] & b_valid[:, None, :]
    d_from_b = torch.sum(
        torch.where(match, b_norm[:, None, :], torch.zeros((), device=match.device)),
        dim=2,
    )
    neg = torch.full_like(d_norm, NEG_INF)
    dense_fused = torch.where(d_valid, d_norm + d_from_b, neg)
    dup = torch.any(match, dim=1)
    lex_fused = torch.where(b_valid & ~dup, b_norm,
                            torch.full_like(b_norm, NEG_INF))

    cand_s = torch.cat([dense_fused, lex_fused], dim=1)
    cand_i = torch.cat([dense_ids.long(), lex_ids.long()], dim=1)
    top_s, pos = _stable_desc(cand_s, min(k, cand_s.shape[1]))
    top_i = torch.gather(cand_i, 1, pos)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, torch.full_like(top_i, -1))
    return top_s, top_i


def gather_rows_device(
    ids: torch.Tensor,
    corpus: torch.Tensor,
    row_scales: Optional[torch.Tensor] = None,
    refine_corpus: Optional[torch.Tensor] = None,
    center: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., d) f32 dequantized stored vectors for row ids of any shape
    (-1 -> zeros), from whichever representation the index keeps: the
    full-precision refine copy, else the stored f32 / bf16 / int8 rows
    times their per-row scales plus the mean they were centered on."""
    safe = torch.clamp(ids.long(), min=0)
    if refine_corpus is not None:
        rows = refine_corpus[safe].float()
    else:
        rows = corpus[safe].float()
        if row_scales is not None:
            rows = rows * row_scales[safe][..., None]
        if center is not None:
            rows = rows + center
    return torch.where(ids[..., None] >= 0, rows, torch.zeros((), device=rows.device))


def rerank_cosine(
    q_emb: torch.Tensor,
    cand_rows: torch.Tensor,
    cand_scores: Optional[torch.Tensor],
    cand_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-cosine rerank of fused candidates: cosine(q, stored row),
    stable sort descending, so cosine ties keep the fused order.
    (cand_scores are not read: the fused order is the candidates' order.)
    Returns (cosine scores, ids), empty slots last with id -1."""
    q32 = q_emb.float()
    with full_f32():
        num = torch.einsum("qd,qkd->qk", q32, cand_rows)
    qn = torch.linalg.norm(q32, dim=1, keepdim=True)
    cn = torch.linalg.norm(cand_rows, dim=2)
    sims = num / torch.clamp(qn * cn, min=1e-12)
    valid = cand_ids >= 0
    sims = torch.where(valid, sims, torch.full_like(sims, NEG_INF))
    top_s, pos = _stable_desc(sims, sims.shape[1])
    top_i = torch.gather(cand_ids.long(), 1, pos)
    return top_s, torch.where(top_s > NEG_INF / 2, top_i,
                              torch.full_like(top_i, -1))
