"""Lexical (BM25 / TF-IDF) top-k over a padded sparse ELL corpus.

The counterpart of ``persian_rag_tpu.ops.sparse_scores``. The corpus is
doc-major padded ELL: ``doc_ids (N, L) int32`` holds each document's
unique term ids (-1 pad) and ``doc_vals (N, L) float32`` the precomputed
per-(doc, term) contribution; the hashed-segment form ``(N, S, Ls)``
keeps the terms with ``tid % S == g`` in segment g. A query batch is
``q_ids (B, T) int32`` (negative = pad) and ``q_vals (B, T) float32``, and

    scores[b, n] = sum_t q_vals[b, t] * doc_vals[n, slot of q_ids[b, t]]

accumulated term by term in query-slot order. Every top-k here ranks by
score descending, then lower doc id (FAISS order, as the JAX package's
running merges keep it).

Four dispatching entries, one per TPU kernel of the JAX package:

* ``sparse_topk``              <- ``_sparse_topk_kernel``
* ``sparse_topk_hashed``       <- ``_sparse_topk_hashed_kernel``
* ``sparse_topk_union``        <- ``_sparse_topk_union_kernel``
* ``sparse_topk_union_hashed`` <- ``_sparse_topk_union_hashed_kernel``

On CUDA tensors each launches its hand-written kernel of
``csrc/sparse_topk.cu`` (per-tile top-k on the card, then a merge of the
tiles on the card; stage 1 of the union entries ``csrc/sparse_stage1.cu``)
or raises; on CPU tensors it runs its plain PyTorch version (``*_plain``);
any other device raises.

The union entries deduplicate the batch's terms (``union_prep`` /
``union_prep_hashed`` in the plain versions, same outputs as the JAX
package; the kernels' blocks build their queries' share themselves) and
contract ``qw (B, U) @ D (U, N)`` in f32 (the kernels: one chain a score
in the union's order): a different summation order from the per-term
entries, so their scores agree to f32 rounding.

The kernels' doc-driven walk keeps a block's query slots in shared memory;
a query of more slots than a block holds (T past ~6,200) is walked in
passes of slots, the chains carried from pass to pass, so every entry takes
any T in its own order (`LookupGeometry.slots`).

Stage 1 of two-pass union serving (the TPU kernels' ``stage1=True``: one
bf16 MXU pass with f32 accumulation, the order of the sum left open) is a
flag of both union entries. Each query's merged union weight and each
matched document value are rounded to bf16 (to nearest even); a bf16
product is exact in f32. The kernel (`union_stage1_cuda`) multiplies them on
the tensor cores (``mma.sync``, f32 accumulators); the plain versions run
one f32 chain over each document's terms in the union's order
(`_union_stage1_topk_plain`). The two agree within `stage1_rel_error`, the
stage-1 term of the proof's bound (`_twopass_rel_bound` derives it), not
bit for bit. ``sparse_topk_union_twopass`` takes the top k_scan of stage 1,
rescores them exactly (``rescore_ell``), and proves the top k or reruns the
batch on the exact union kernel.

Left behind, on purpose: ``_exact_split_dot`` and the ``qw_exact``
variants. They only cut TPU MXU passes (bf16 splits that keep HIGHEST's
accuracy). The CUDA kernels multiply and add in f32 on the CUDA cores,
which is exact-class without splits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.ops.flat_topk import NEG_INF, full_f32

# union_prep's chunk of union terms (the plain versions' dedup, as the JAX
# package's)
UNION_CHUNK = 64
# rows of the (B, N) plain score block kept at once (elements)
_PLAIN_BUDGET = 64 * 1024 * 1024


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Plain scores (the reference arithmetic).
# ---------------------------------------------------------------------------


def _term_columns(doc_ids: torch.Tensor, doc_vals: torch.Tensor,
                  terms: torch.Tensor) -> torch.Tensor:
    """D (U, N): D[u, n] = doc n's value for term terms[u] (0 when absent).
    `terms` is sorted ascending; entries that are not real ids (< 0) get
    zero rows. A doc's term ids are unique, so each D entry is one value."""
    n, el = doc_ids.shape
    u = terms.numel()
    d = torch.zeros((u, n), dtype=torch.float32, device=doc_vals.device)
    if u == 0 or el == 0:
        return d
    flat = doc_ids.reshape(-1).long()
    pos = torch.searchsorted(terms, flat).clamp(max=u - 1)
    hit = (flat >= 0) & (terms[pos] == flat)
    rows = torch.arange(n, device=doc_ids.device).repeat_interleave(el)
    d.index_put_((pos[hit], rows[hit]), doc_vals.reshape(-1)[hit].float(),
                 accumulate=True)
    return d


def _chunk_rows(b: int, u: int, n: int) -> int:
    """Corpus rows per plain block so (B + U) x rows stays in budget."""
    return max(1, min(n, _PLAIN_BUDGET // max(1, b + u)))


def _scores_block(doc_ids, doc_vals, q_ids, q_vals, terms):
    """(B, n) scores of one corpus block: per query slot in order,
    carry + q_val * contribution (pads contribute 0)."""
    d = _term_columns(doc_ids, doc_vals, terms)
    b, t = q_ids.shape
    carry = torch.zeros((b, doc_ids.shape[0]), dtype=torch.float32,
                        device=doc_vals.device)
    if terms.numel() == 0:
        return carry
    for ti in range(t):
        q = q_ids[:, ti].long()
        pos = torch.searchsorted(terms, q).clamp(max=terms.numel() - 1)
        contrib = torch.where((q >= 0)[:, None], d[pos],
                              torch.zeros((), device=d.device))
        carry = carry + q_vals[:, ti, None].float() * contrib
    return carry


def _query_terms(q_ids: torch.Tensor) -> torch.Tensor:
    return torch.unique(q_ids[q_ids >= 0].long())


def sparse_scores_ref(
    doc_ids: torch.Tensor,
    doc_vals: torch.Tensor,
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
) -> torch.Tensor:
    """Dense (B, N) lexical scores, accumulated term by term in
    query-slot order as the JAX package's scan does."""
    terms = _query_terms(q_ids)
    n = doc_ids.shape[0]
    step = _chunk_rows(q_ids.shape[0], terms.numel(), n)
    parts = [
        _scores_block(doc_ids[s:s + step], doc_vals[s:s + step], q_ids,
                      q_vals, terms)
        for s in range(0, n, step)
    ]
    if not parts:
        return torch.zeros((q_ids.shape[0], 0), device=doc_vals.device)
    return torch.cat(parts, dim=1)


def _stable_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, score descending, lower position first on ties
    (torch.topk promises no tie order)."""
    vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _running_topk(block_scores, n: int, b: int, u: int, k: int, device):
    """Stable running top-k over corpus blocks: earlier blocks (lower ids)
    precede later ones, so ties keep the lower id."""
    step = _chunk_rows(b, u, n)
    run_s = torch.empty((b, 0), dtype=torch.float32, device=device)
    run_i = torch.empty((b, 0), dtype=torch.long, device=device)
    for start in range(0, n, step):
        s = block_scores(start, min(n, start + step))
        top_s, top_i = _stable_topk(s, min(k, s.shape[1]))
        run_s, pos = _stable_topk(torch.cat([run_s, top_s], dim=1), k)
        run_i = torch.gather(torch.cat([run_i, top_i + start], dim=1), 1, pos)
    return run_s, run_i.int()


def sparse_topk_plain(
    doc_ids: torch.Tensor,
    doc_vals: torch.Tensor,
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-term kernel: `sparse_scores_ref` block by
    block and a stable running top-k. ((B, k) f32, (B, k) int32)."""
    n = doc_ids.shape[0]
    k = min(k, n)
    terms = _query_terms(q_ids)
    return _running_topk(
        lambda s, e: _scores_block(doc_ids[s:e], doc_vals[s:e], q_ids,
                                   q_vals, terms),
        n, q_ids.shape[0], terms.numel(), k, doc_vals.device,
    )


def sparse_topk_hashed_plain(doc_ids3, doc_vals3, q_ids, q_vals, k):
    """Plain version of the hashed per-term kernel: segments only
    partition a row's entries, so it scores the flattened (N, S*Ls) ELL
    (identical values)."""
    n, s_n, ls = doc_ids3.shape
    return sparse_topk_plain(doc_ids3.reshape(n, s_n * ls),
                             doc_vals3.reshape(n, s_n * ls), q_ids, q_vals, k)


def _union_topk_plain(doc_ids, doc_vals, u_ids, qw, k):
    """qw (B, U) @ D (U, N) in full f32 over the prepared union slots, and
    a stable running top-k. Slots whose id is a pad (-2) are zero rows."""
    n = doc_ids.shape[0]
    k = min(k, n)
    u_flat = u_ids.reshape(-1).long()
    b = qw.shape[1]
    qw_bu = qw.permute(1, 0, 2).reshape(b, -1).float()
    sorted_u, perm = torch.sort(u_flat)

    def block(s, e):
        d_sorted = _term_columns(doc_ids[s:e], doc_vals[s:e], sorted_u)
        d = torch.empty_like(d_sorted)
        d[perm] = d_sorted
        with full_f32():
            return qw_bu @ d

    return _running_topk(block, n, b, u_flat.numel(), k, doc_vals.device)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (to nearest even) and widened back."""
    return x.float().bfloat16().float()


def _union_stage1_topk_plain(doc_ids, doc_vals, u_ids, qw, k):
    """Stage 1 over the prepared union slots: per document, its terms in
    the union's slot order, acc = acc + bf16(qw) * bf16(value) in f32 from
    +0 (the product is exact), and a stable running top-k. Terms a query
    lacks add qw = 0, which leaves a chain from +0 as it is: the kernel's
    chain over the terms the query and the document share, bit for bit."""
    n, el = doc_ids.shape
    k = min(k, n)
    u_flat = u_ids.reshape(-1).long()
    b = qw.shape[1]
    qw16 = _bf16_round(qw.permute(1, 0, 2).reshape(b, -1))
    qw16 = torch.cat([qw16, torch.zeros((b, 1), device=qw16.device)], dim=1)
    miss = u_flat.numel()  # the zero column
    sorted_u, perm = torch.sort(u_flat)

    def block(s, e):
        ids = doc_ids[s:e].long()
        pos = torch.searchsorted(sorted_u, ids).clamp(max=miss - 1)
        hit = (ids >= 0) & (sorted_u[pos] == ids)
        slot = torch.where(hit, perm[pos], torch.full_like(pos, miss))
        slot, order = torch.sort(slot, dim=1)
        vals = _bf16_round(torch.gather(doc_vals[s:e], 1, order))
        acc = torch.zeros((b, e - s), dtype=torch.float32,
                          device=doc_vals.device)
        for col in range(el):
            w = qw16[:, slot[:, col]]
            acc = acc + w * vals[None, :, col]
        return acc

    return _running_topk(block, n, b, b + 2 * el, k, doc_vals.device)


def sparse_topk_union_plain(doc_ids, doc_vals, q_ids, q_vals, k,
                            stage1: bool = False):
    """Plain version of the union kernel: `union_prep`, then the f32
    contraction over the union terms (stage1: the bf16-rounded chain of
    `_union_stage1_topk_plain`)."""
    u_ids, qw, _ = union_prep(q_ids, q_vals, UNION_CHUNK)
    topk = _union_stage1_topk_plain if stage1 else _union_topk_plain
    return topk(doc_ids, doc_vals, u_ids, qw, k)


def sparse_topk_union_hashed_plain(doc_ids3, doc_vals3, q_ids, q_vals, k,
                                   stage1: bool = False):
    """Plain version of the hashed union kernel: `union_prep_hashed`,
    then the same contraction over the flattened segments."""
    n, s_n, ls = doc_ids3.shape
    u_ids, qw, _, _ = union_prep_hashed(q_ids, q_vals, UNION_CHUNK, s_n)
    topk = _union_stage1_topk_plain if stage1 else _union_topk_plain
    return topk(doc_ids3.reshape(n, s_n * ls),
                doc_vals3.reshape(n, s_n * ls), u_ids, qw, k)


# ---------------------------------------------------------------------------
# Host and device preparation.
# ---------------------------------------------------------------------------


def hash_segments(
    per_doc_ids: np.ndarray,
    per_doc_vals: np.ndarray,
    n_segments: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side repack of an (N, L) ELL into (N, S, Ls) hashed-segment
    form (NumPy; build time only). Segment g of a doc holds its terms with
    tid % S == g in ELL order, -1/0 padded to the corpus-wide max segment
    height rounded up to a multiple of 8."""
    ids = np.asarray(per_doc_ids)
    vals = np.asarray(per_doc_vals)
    n, el = ids.shape
    seg_of = np.where(ids >= 0, ids % n_segments, -1)
    counts = np.zeros((n, n_segments), np.int64)
    for g in range(n_segments):
        counts[:, g] = (seg_of == g).sum(axis=1)
    ls = max(1, int(counts.max()))
    ls = ((ls + 7) // 8) * 8
    out_ids = np.full((n, n_segments, ls), -1, np.int32)
    out_vals = np.zeros((n, n_segments, ls), np.float32)
    doc_idx, slot_idx = np.nonzero(ids >= 0)
    segs = seg_of[doc_idx, slot_idx]
    order = np.lexsort((slot_idx, segs, doc_idx))
    d_o, s_o, g_o = doc_idx[order], slot_idx[order], segs[order]
    pos = np.zeros(len(order), np.int64)
    if len(order):
        new_group = np.ones(len(order), bool)
        new_group[1:] = (d_o[1:] != d_o[:-1]) | (g_o[1:] != g_o[:-1])
        starts = np.nonzero(new_group)[0]
        pos = np.arange(len(order)) - np.repeat(
            starts, np.diff(np.append(starts, len(order)))
        )
    out_ids[d_o, g_o, pos] = ids[d_o, s_o]
    out_vals[d_o, g_o, pos] = vals[d_o, s_o]
    return out_ids, out_vals


def _prep_common(q_ids, q_vals, key):
    """Sort a (B, T) batch's slots by `key` (pads last, stable) and mark
    each distinct real id's first slot."""
    flat = q_ids.reshape(-1).long()
    fval = q_vals.reshape(-1).float()
    valid = flat >= 0
    order = torch.argsort(key, stable=True)
    big = torch.full_like(flat, 2 ** 31 - 1)
    s = torch.where(valid, flat, big)[order]
    sval = valid[order]
    first = torch.cat([sval[:1], (s[1:] != s[:-1]) & sval[1:]])
    return flat, fval, valid, order, s, sval, first


def _scatter_qw(b, t, cap, order, slot_sorted, valid, fval, device):
    """qw (B, cap): each query's weight per union slot (duplicates sum)."""
    m = b * t
    slot_flat = torch.zeros(m, dtype=torch.long, device=device)
    slot_flat[order] = slot_sorted
    rows = torch.arange(m, device=device) // max(t, 1)
    qw = torch.zeros((b, cap + 1), dtype=torch.float32, device=device)
    qw.index_put_(
        (rows, torch.where(valid, slot_flat, torch.full_like(slot_flat, cap))),
        torch.where(valid, fval, torch.zeros_like(fval)), accumulate=True,
    )
    return qw[:, :cap]


def union_prep(
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
    u_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate a (B, T) query batch into union-term form, on the
    batch's device (no host read).

    Returns u_ids (NC, 1, UC) int32, the distinct ids ascending then -2
    pads; qw (NC, B, UC) f32, each query's weight per union slot
    (within-query duplicates sum); n_chunks () int32, the chunks that hold
    real ids. NC * UC = B*T rounded up to UC."""
    b, t = q_ids.shape
    m = b * t
    dev = q_ids.device
    u_cap = _round_up(max(m, u_chunk), u_chunk)
    nc_max = u_cap // u_chunk
    valid0 = q_ids.reshape(-1) >= 0
    key = torch.where(valid0, q_ids.reshape(-1).long(),
                      torch.full((m,), 2 ** 31 - 1, device=dev))
    flat, fval, valid, order, s, sval, first = _prep_common(q_ids, q_vals, key)
    slot_sorted = torch.cumsum(first.long(), 0) - 1
    n_union = first.long().sum()
    u_ids = torch.full((u_cap + 1,), -2, dtype=torch.long, device=dev)
    u_ids[torch.where(sval, slot_sorted, torch.full_like(slot_sorted, u_cap))] = \
        torch.where(sval, s, torch.full_like(s, -2))
    qw = _scatter_qw(b, t, u_cap, order, slot_sorted, valid, fval, dev)
    n_chunks = (n_union + u_chunk - 1) // u_chunk
    return (
        u_ids[:u_cap].int().reshape(nc_max, 1, u_chunk),
        qw.reshape(b, nc_max, u_chunk).permute(1, 0, 2).contiguous(),
        n_chunks.int(),
    )


def union_prep_hashed(
    q_ids: torch.Tensor,
    q_vals: torch.Tensor,
    u_chunk: int,
    n_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segment-grouped batch dedup, on the batch's device.

    Returns u_ids (NC, 1, UC) int32, union ids by (tid % S, tid) with each
    segment's run padded (-2) to a chunk boundary, so a chunk's real ids
    share one segment; qw (NC, B, UC) f32; chunk_seg (1, NC) int32, the
    segment of each chunk; n_chunks () int32, the populated chunks.
    NC = ceil(B*T / UC) + S covers the per-segment padding."""
    b, t = q_ids.shape
    m = b * t
    s_n = n_segments
    dev = q_ids.device
    u_cap = _round_up(max(m, u_chunk), u_chunk)
    nc_max = u_cap // u_chunk + s_n
    cap = nc_max * u_chunk
    flat0 = q_ids.reshape(-1).long()
    valid0 = flat0 >= 0
    seg = torch.where(valid0, flat0 % s_n, torch.full_like(flat0, s_n - 1))
    # (segment, tid) sort key; tid < 2^26 and S <= 16 fit an int32 key
    key = torch.where(valid0, seg * (1 << 26) + flat0,
                      torch.full_like(flat0, 2 ** 31 - 1))
    flat, fval, valid, order, s_sorted, sval, first = _prep_common(
        q_ids, q_vals, key)
    sseg = seg[order]
    uniq_rank = torch.cumsum(first.long(), 0) - 1
    onehot = sseg[:, None] == torch.arange(s_n, device=dev)[None, :]
    cnt = (onehot & first[:, None]).long().sum(dim=0)
    padded = ((cnt + u_chunk - 1) // u_chunk) * u_chunk
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    off = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    seg_rank_start = torch.cat([zero, torch.cumsum(cnt, 0)[:-1]])
    slot_sorted = uniq_rank - seg_rank_start[sseg] + off[sseg]
    u_ids = torch.full((cap + 1,), -2, dtype=torch.long, device=dev)
    keep = sval & first
    u_ids[torch.where(keep, slot_sorted, torch.full_like(slot_sorted, cap))] = \
        torch.where(sval, s_sorted, torch.full_like(s_sorted, -2))
    qw = _scatter_qw(b, t, cap, order, slot_sorted, valid, fval, dev)
    ends = torch.cumsum(padded, 0)
    chunk_start = torch.arange(nc_max, device=dev) * u_chunk
    chunk_seg = (chunk_start[:, None] >= ends[None, :]).long().sum(dim=1)
    chunk_seg = torch.clamp(chunk_seg, max=s_n - 1)
    n_chunks = ends[-1] // u_chunk
    return (
        u_ids[:cap].int().reshape(nc_max, 1, u_chunk),
        qw.reshape(b, nc_max, u_chunk).permute(1, 0, 2).contiguous(),
        chunk_seg.int().reshape(1, nc_max),
        n_chunks.int(),
    )


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/sparse_topk.cu; stage 1: csrc/sparse_stage1.cu).
# ---------------------------------------------------------------------------


def _tile_k(k: int, tile: int) -> int:
    """The per-tile list length kt = min(k, tile) for a caller's k >= 1.
    A tile holds at most `tile` documents, so for k above it each tile
    gives all of them and the merge of the tiles is still exact."""
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    return min(k, tile)


def _check_cuda(tensors) -> torch.device:
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for name, t, dtype in tensors:
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _merge_tiles(out_s, out_i, k):
    """(B, J, kt) per-tile top lists (tiles in id order, each by score
    descending then id) -> (B, k) by a stable sort: ties keep the lower
    id. The plain version of the card's merge (`merge_tiles_kernel`)."""
    b = out_s.shape[0]
    s, pos = _stable_topk(out_s.reshape(b, -1), k)
    return s, torch.gather(out_i.reshape(b, -1), 1, pos)


class LookupGeometry(NamedTuple):
    """One launch of a doc-driven walk (#10 `prt_sparse_topk`, #11
    `prt_sparse_topk_hashed`, and #12 and #13 at theirs): `queries` a block,
    `tile` documents a block, `threads` a block, `smem` bytes of shared
    memory a block, `query_blocks` (the grid is query_blocks x ceil(N /
    tile)), `table_slots` (the block's hash table of query terms) and
    `slots`, the query slots a pass: T where a block holds them all, else
    fewer (one query a block), the walk then taking ceil(T / slots)
    passes."""
    queries: int
    tile: int
    threads: int
    smem: int
    query_blocks: int
    table_slots: int
    slots: int


@functools.lru_cache(maxsize=1024)
def _geometry(entry: str, kernel: str, *args: int) -> LookupGeometry:
    """The launch the C geometry `entry` reports for `kernel` at (B, T[,
    N])."""
    from persian_rag_tpu_torch.ops import _build

    lib = _build.load()
    geo = (ctypes.c_int * 7)()
    if getattr(lib, entry)(*args, geo) != 0:
        raise ValueError(
            f"{args[0]} queries of width T={args[1]}: no launch of {kernel} "
            "fits the grid (65,535 tiles) and T <= 2^20")
    return LookupGeometry(*geo)


def sparse_topk_geometry(b: int, t: int, n: int) -> LookupGeometry:
    """The launch that #10 makes for B queries of T slots over N documents,
    as its C entry reports it (`prt_sparse_topk_geometry`, the same choice
    that picks the launch): #11's query block, and the largest tile (256
    down to 32) whose grid gives every SM two blocks. The doc rows' width
    does not enter it. Raises ValueError when no launch fits."""
    return _geometry("prt_sparse_topk_geometry", "prt_sparse_topk", b, t, n)


def sparse_topk_union_geometry(b: int, t: int, n: int) -> LookupGeometry:
    """The launch that #12 makes for B queries of T slots over N documents:
    #10's (`prt_sparse_topk_union` takes the choice of
    `prt_sparse_topk_geometry`). Raises ValueError when no launch fits."""
    return _geometry("prt_sparse_topk_geometry", "prt_sparse_topk_union", b,
                     t, n)


def sparse_topk_union_hashed_geometry(b: int, t: int) -> LookupGeometry:
    """The launch that #13's walk makes for B queries of T slots: #11's
    (`prt_sparse_topk_union_hashed` takes the choice of
    `prt_sparse_topk_hashed_geometry`). Raises ValueError when no launch
    fits."""
    return _geometry("prt_sparse_topk_hashed_geometry",
                     "prt_sparse_topk_union_hashed", b, t)


def sparse_topk_hashed_geometry(b: int, t: int) -> LookupGeometry:
    """The launch that #11 makes for B queries of T slots, as its C entry
    reports it (`prt_sparse_topk_hashed_geometry`, the same choice that
    picks the launch): tiles of 256 documents; the doc rows' width does not
    enter it. Raises ValueError when no launch fits a block's shared
    memory."""
    return _geometry("prt_sparse_topk_hashed_geometry",
                     "prt_sparse_topk_hashed", b, t)


def _launch_term(fn_name, geo, q_ids, q_vals, ids3, vals3, k):
    """`fn_name` over the corpus tiles of `geo.tile` documents: the kernel
    writes each tile's list, and a merge kernel in the same C call ranks a
    query's lists as `_merge_tiles` does (a stable sort by score: ties keep
    the lower id). k is clamped to N."""
    from persian_rag_tpu_torch.ops import _build

    b, t = q_ids.shape
    n, s_n, ls = ids3.shape
    k = min(k, n)
    kt = _tile_k(k, geo.tile)
    n_tiles = -(-n // geo.tile)
    if n_tiles > 65535:
        raise ValueError(f"N={n} exceeds the kernel grid (65535 tiles)")
    dev = q_ids.device
    tile_s = torch.empty((b, n_tiles, kt), dtype=torch.float32, device=dev)
    tile_i = torch.empty((b, n_tiles, kt), dtype=torch.int32, device=dev)
    res_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    res_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            q_ids.data_ptr(), q_vals.data_ptr(), ids3.data_ptr(),
            vals3.data_ptr(), tile_s.data_ptr(), tile_i.data_ptr(),
            res_s.data_ptr(), res_i.data_ptr(), b, t, n, s_n, ls, kt, k,
            stream,
        )
    _build.check(lib, err, f"{fn_name} launch")
    return res_s, res_i


class Stage1Geometry(NamedTuple):
    """One launch of the stage-1 kernel (`prt_sparse_topk_union_stage1` and
    `prt_sparse_topk_union_hashed_stage1`, `csrc/sparse_stage1.cu`):
    `queries` a block, `tile` documents a tile, `threads` a block, `smem`
    bytes of shared memory a block, `query_blocks` (the grid's x) and
    `groups` blocks a query block (its y: each walks every groups-th tile),
    `lists` lists a query of the final merge (for k <= 32 a block's running
    list, and the first round's merged top k where the walk takes more
    than a round; else one a tile) of `kt` entries, `chunk` union terms a
    product step, `cells` query slots a pass, `blocks_per_sm` (the
    occupancy API's), `scratch` bytes the launch needs."""
    queries: int
    tile: int
    threads: int
    smem: int
    query_blocks: int
    groups: int
    lists: int
    kt: int
    chunk: int
    cells: int
    blocks_per_sm: int
    scratch: int


@functools.lru_cache(maxsize=1024)
def sparse_stage1_geometry(b: int, t: int, n: int, k: int, segments: int = 1,
                           device: int = 0) -> Stage1Geometry:
    """The stage-1 kernel's launch for B queries of T slots over N documents
    of `segments` segments a row (the flat ELL: 1; the tiles differ) at k
    (1 <= k <= N) on CUDA device `device`, as its C entry reports it
    (`prt_sparse_stage1_geometry`, the same choice that picks the launch:
    the grid and the scratch follow the device's SMs). Needs the card.
    Raises ValueError when no launch fits."""
    from persian_rag_tpu_torch.ops import _build

    lib = _build.load()
    geo = (ctypes.c_longlong * 12)()
    with torch.cuda.device(device):
        err = lib.prt_sparse_stage1_geometry(b, t, n, segments, k, geo)
    if err != 0:
        raise ValueError(f"{b} queries of width T={t} over N={n} at k={k}: "
                         "no stage-1 launch fits")
    return Stage1Geometry(*geo)


def union_stage1_cuda(ids3, vals3, q_ids, q_vals, k: int):
    """The stage-1 kernel over an (N, S, Ls) corpus (the flat ELL: S = 1),
    k clamped to N: each query's weight per distinct term and each matched
    value rounded to bf16, their products summed on the tensor cores, the
    top k by score, then lower id, merged on the card. The union wrappers'
    stage1=True calls it and count its launches; the inputs are the
    wrappers' (`_term_inputs`)."""
    from persian_rag_tpu_torch.ops import _build

    b, t = q_ids.shape
    n, s_n, ls = ids3.shape
    k = min(k, n)
    dev = q_ids.device
    geo = sparse_stage1_geometry(b, t, n, k, s_n, dev.index)
    scratch = torch.empty(geo.scratch, dtype=torch.uint8, device=dev)
    res_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    res_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    name = ("prt_sparse_topk_union_stage1" if s_n == 1
            else "prt_sparse_topk_union_hashed_stage1")
    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            q_ids.data_ptr(), q_vals.data_ptr(), ids3.data_ptr(),
            vals3.data_ptr(), scratch.data_ptr(), geo.scratch,
            res_s.data_ptr(), res_i.data_ptr(), b, t, n, s_n, ls, k,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"{name} launch")
    return res_s, res_i


def _term_inputs(q_ids, q_vals, ids3, vals3, k) -> None:
    """The per-term wrappers' checks before any device work: k, then the
    tensors' device, types and layout."""
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    _check_cuda([("q_ids", q_ids, torch.int32),
                 ("q_vals", q_vals, torch.float32),
                 ("doc_ids", ids3, torch.int32),
                 ("doc_vals", vals3, torch.float32)])


def sparse_topk_cuda(doc_ids, doc_vals, q_ids, q_vals, k):
    """CUDA kernel for `_sparse_topk_kernel`'s contract (flat ELL), any
    k >= 1 (clamped to N): #11's doc-driven lookup, at the tile
    `sparse_topk_geometry` picks. Each tile lists its top min(k, tile); the
    per-tile buffer takes B * ceil(N / tile) * kt * 8 bytes. `launches`
    counts its launches."""
    n, el = doc_ids.shape
    ids3, vals3 = doc_ids.view(n, 1, el), doc_vals.view(n, 1, el)
    _term_inputs(q_ids, q_vals, ids3, vals3, k)
    geo = sparse_topk_geometry(*q_ids.shape, n)  # raises past the C limits
    out = _launch_term("prt_sparse_topk", geo, q_ids, q_vals, ids3, vals3, k)
    sparse_topk_cuda.launches += 1
    return out


def sparse_topk_hashed_cuda(doc_ids3, doc_vals3, q_ids, q_vals, k):
    """CUDA kernel for `_sparse_topk_hashed_kernel`'s contract, any k >= 1
    (clamped to N): a doc-driven lookup of each document's slots in a table
    of the query block's terms (`sparse_topk_hashed_geometry`); each
    256-document tile
    lists its top min(k, 256), B * ceil(N / 256) * kt * 8 bytes (about 51
    MB at B=64, k >= 256 over 100k documents). `launches` counts."""
    _term_inputs(q_ids, q_vals, doc_ids3, doc_vals3, k)
    geo = sparse_topk_hashed_geometry(*q_ids.shape)  # raises past the limits
    out = _launch_term("prt_sparse_topk_hashed", geo, q_ids, q_vals, doc_ids3,
                       doc_vals3, k)
    sparse_topk_hashed_cuda.launches += 1
    return out


def sparse_topk_union_cuda(doc_ids, doc_vals, q_ids, q_vals, k,
                           stage1: bool = False):
    """CUDA kernel for `_sparse_topk_union_kernel`'s contract (the scores
    of `union_prep`'s qw over the union terms): #10's doc-driven walk at
    `sparse_topk_union_geometry`'s launch, whose blocks take their queries'
    distinct terms in ascending id order (the union's) with the weights qw
    holds, so that each score is one f32 chain over the union terms that
    the query and the doc share (the dense chain's bits); the tile lists
    merged on the card. Any k >= 1 (clamped to N): each tile lists its top
    min(k, tile); the per-tile buffer takes B * ceil(N / tile) * kt * 8
    bytes. stage1=True is the candidate pass on the tensor cores
    (`union_stage1_cuda`, `prt_sparse_topk_union_stage1`). `launches`
    counts the exact launches, `stage1_launches` the stage-1 ones."""
    n, el = doc_ids.shape
    ids3, vals3 = doc_ids.view(n, 1, el), doc_vals.view(n, 1, el)
    _term_inputs(q_ids, q_vals, ids3, vals3, k)
    if stage1:
        out = union_stage1_cuda(ids3, vals3, q_ids, q_vals, k)
        sparse_topk_union_cuda.stage1_launches += 1
        return out
    geo = sparse_topk_union_geometry(*q_ids.shape, n)  # raises past the limits
    out = _launch_term("prt_sparse_topk_union", geo, q_ids, q_vals, ids3,
                       vals3, k)
    sparse_topk_union_cuda.launches += 1
    return out


def sparse_topk_union_hashed_cuda(doc_ids3, doc_vals3, q_ids, q_vals, k,
                                  stage1: bool = False):
    """CUDA kernel for `_sparse_topk_union_hashed_kernel`'s contract (the
    scores of `union_prep_hashed`'s qw over the union terms, in its (tid %
    S, tid) order): #11's doc-driven walk at
    `sparse_topk_union_hashed_geometry`'s launch, whose blocks take their
    queries' distinct terms in that order with the weights qw holds, so
    that each score is one f32 chain over the union terms that the query
    and the doc share (the dense chain's bits); the tile lists merged on the
    card. Any k >= 1 (clamped to N): each tile lists its top min(k, 256);
    the per-tile buffer takes B * ceil(N / 256) * kt * 8 bytes. stage1=True
    is the candidate pass (`union_stage1_cuda`,
    `prt_sparse_topk_union_hashed_stage1`), as `sparse_topk_union_cuda`'s.
    `launches` counts its exact launches, `stage1_launches` the stage-1
    ones."""
    _term_inputs(q_ids, q_vals, doc_ids3, doc_vals3, k)
    if stage1:
        out = union_stage1_cuda(doc_ids3, doc_vals3, q_ids, q_vals, k)
        sparse_topk_union_hashed_cuda.stage1_launches += 1
        return out
    geo = sparse_topk_union_hashed_geometry(*q_ids.shape)
    out = _launch_term("prt_sparse_topk_union_hashed", geo, q_ids, q_vals,
                       doc_ids3, doc_vals3, k)
    sparse_topk_union_hashed_cuda.launches += 1
    return out


for _fn in (sparse_topk_cuda, sparse_topk_hashed_cuda, sparse_topk_union_cuda,
            sparse_topk_union_hashed_cuda):
    _fn.launches = 0
sparse_topk_union_cuda.stage1_launches = 0
sparse_topk_union_hashed_cuda.stage1_launches = 0

KERNELS = {
    "sparse_topk": sparse_topk_cuda,
    "sparse_topk_hashed": sparse_topk_hashed_cuda,
    "sparse_topk_union": sparse_topk_union_cuda,
    "sparse_topk_union_hashed": sparse_topk_union_hashed_cuda,
}


# ---------------------------------------------------------------------------
# Dispatching entries.
# ---------------------------------------------------------------------------


def _dispatch(plain, kernel, docs, q_ids, q_vals, k: int, name: str, **kw):
    k = min(k, docs[0].shape[0])
    dev = q_ids.device.type
    if docs[0].device != q_ids.device:
        raise ValueError("corpus and queries must be on one device")
    if dev == "cpu":
        return plain(*docs, q_ids, q_vals, k, **kw)
    if dev == "cuda":
        return kernel(*docs, q_ids.int().contiguous(),
                      q_vals.float().contiguous(), k, **kw)
    raise ValueError(f"no {name} kernel for device type {dev}")


def sparse_topk(doc_ids, doc_vals, q_ids, q_vals, k: int):
    """Fused lexical scores + top-k over a flat (N, L) ELL.
    Returns ((B, k) f32 scores, (B, k) int32 ids), k clamped to N."""
    return _dispatch(sparse_topk_plain, sparse_topk_cuda,
                     (doc_ids, doc_vals), q_ids, q_vals, k, "sparse_topk")


def sparse_topk_hashed(doc_ids3, doc_vals3, q_ids, q_vals, k: int):
    """As `sparse_topk` over an (N, S, Ls) hashed-segment corpus."""
    return _dispatch(sparse_topk_hashed_plain, sparse_topk_hashed_cuda,
                     (doc_ids3, doc_vals3), q_ids, q_vals, k,
                     "sparse_topk_hashed")


def _stage1_flag(stage1: bool) -> dict:
    """The keyword that asks a union kernel or plain version for stage 1
    (none for the exact mode: those calls keep their exact-mode form)."""
    return {"stage1": True} if stage1 else {}


def sparse_topk_union(doc_ids, doc_vals, q_ids, q_vals, k: int,
                      stage1: bool = False):
    """Batch-deduplicated lexical top-k over a flat ELL (same tie order;
    scores to f32 summation order). stage1=True: the bf16 candidate pass
    (see the module docstring)."""
    return _dispatch(sparse_topk_union_plain, sparse_topk_union_cuda,
                     (doc_ids, doc_vals), q_ids, q_vals, k,
                     "sparse_topk_union", **_stage1_flag(stage1))


def sparse_topk_union_hashed(doc_ids3, doc_vals3, q_ids, q_vals, k: int,
                             stage1: bool = False):
    """Segment-grouped batch-dedup top-k over a hashed-segment corpus
    (stage1 as `sparse_topk_union`)."""
    return _dispatch(sparse_topk_union_hashed_plain,
                     sparse_topk_union_hashed_cuda, (doc_ids3, doc_vals3),
                     q_ids, q_vals, k, "sparse_topk_union_hashed",
                     **_stage1_flag(stage1))


# ---------------------------------------------------------------------------
# Two-pass union serving: stage-1 candidates, exact rescore, proof.
#
# Every BM25 / TF-IDF contribution is nonnegative (the caller gates on it),
# so a stage-1 score brackets the exact one by a relative bound:
#   stage1(d) in [exact(d) (1 - delta), exact(d) (1 + delta)],
#   delta = 2 * 2^-9 (bf16 rounding of qw and of the value)
#         + stage1_rel_error(U, T) (stage 1's f32 accumulation: the tensor
#           cores' or the plain chain's, `_twopass_rel_bound` derives it)
#         + (L + T) * 2^-24 (the exact score's f32 accumulation).
# Every document outside the top k_scan of stage 1 scores at most the
# k_scan-th stage-1 score times (1 + delta'); the candidates are rescored
# exactly, and where the k-th rescored score clears that bound for every
# query the top k is proven; else the whole batch reruns on the exact union
# kernel.
# ---------------------------------------------------------------------------


def rescore_ell(ell_ids, ell_vals, q_ids, q_vals, cand) -> torch.Tensor:
    """Exact f32 rescore of candidate rows: cand (B, C) doc ids (negative =
    padding -> NEG_INF score). Per query slot in order, carry + q_val *
    the row's value for the term (0 when absent; a row's ids are unique):
    the per-term kernels' arithmetic."""
    safe = cand.long().clamp(min=0)
    rows_i = ell_ids[safe]  # (B, C, L)
    rows_v = ell_vals[safe]
    zero = torch.zeros((), dtype=torch.float32, device=ell_vals.device)
    carry = torch.zeros(cand.shape, dtype=torch.float32,
                        device=ell_vals.device)
    for t in range(q_ids.shape[1]):
        match = rows_i == q_ids[:, t, None, None]
        contrib = torch.where(match, rows_v, zero).sum(dim=-1)
        carry = carry + q_vals[:, t, None].float() * contrib
    return torch.where(cand >= 0, carry, torch.full_like(carry, NEG_INF))


# What one k-step of the tensor cores' f32 accumulation may lose, relative
# to its result, for nonnegative products (see `_twopass_rel_bound`)
TC_STEP_REL = 3.0 * 2.0 ** -20


def stage1_rel_error(u: float, t: int) -> float:
    """How far a stage-1 score may lie from the exact sum of its bf16
    products, relative to it, on the card or on the CPU: min(T, U) k-steps
    that can lose, TC_STEP_REL each (derived in `_twopass_rel_bound`)."""
    return min(float(t), float(u)) * TC_STEP_REL


def _twopass_rel_bound(u: float, t: int, l_slots: int) -> float:
    """Relative clearance factor (see above): u bounds the batch's distinct
    union terms (the serving path passes its count; else the worst case
    B * T). 2^-16 more covers the f32 order between the rescore and the
    exact union kernel, and the second-order terms below.

    Stage 1's accumulation term, `stage1_rel_error`. The kernel sums a
    score's exact bf16 products (16 significant bits each, exact in f32)
    with mma.sync.m16n8k16, bf16 in, f32 out, 16 union terms a k-step. The
    model of that accumulation (held on the card by chip_smoke.py's
    adversarial stage-1 batch, which prints its largest error beside this
    term): a k-step adds its 16 products to the running sum c in groups of
    g >= 4 products; a group's addends (its products and c) are aligned to
    the largest exponent among them and cut to 24 significant bits below
    it, so each loses less than 2^-23 of the largest, which for nonnegative
    addends is less than 2^-23 of the group's exact sum; the aligned values
    are added exactly, and the sum is written as an f32, truncated or
    rounded: less than 2^-23 of it. So a group loses less than (g + 2)
    2^-23 of its result and a k-step less than (16 + 32 / g) 2^-23 <= 24
    2^-23 = 3 2^-20 (TC_STEP_REL). A k-step whose 16 products are all zero
    returns c itself (c alone is aligned and keeps its 24 bits), so only
    the k-steps that hold a term the query and the document share can
    lose: at most T (a query's distinct terms, each in one k-step of one
    pass and chunk) and at most U; in a single pass also at most the
    ceil(U_b / 16) k-steps run, U_b the block's distinct terms. Nonnegative
    losses compound: stage1 in [P (1 - e)^m, P (1 + e)^m], P the exact sum
    of the products, e = 3 2^-20, m = min(T, U), first order m e. At the
    served T <= 16 that is at most 16 * 3 2^-20 = 2^-14.4, under 2^-12
    (the bf16 term is 2 2^-9). The plain versions' f32 chain, rounded to
    nearest, loses at most 2^-24 a nonzero product, m 2^-24 < m e: the one
    term bounds stage 1 whichever device ran it."""
    delta = (2.0 * 2.0 ** -9 + stage1_rel_error(u, t)
             + (l_slots + t) * 2.0 ** -24)
    return delta / (1.0 - delta) + 2.0 ** -16


def sparse_topk_union_twopass(doc_ids, doc_vals, doc_ids3, doc_vals3, q_ids,
                              q_vals, k: int, k_scan: int = 32,
                              n_union=None, return_ok: bool = False):
    """Two-pass exact lexical top-k: the union kernel's stage 1 at k_scan,
    the exact rescore of those candidates, and the residual proof.

    doc_ids / doc_vals: the primary ELL ((N, L) flat or (N, S, Ls) hashed;
    the rescore flattens either); doc_ids3 / doc_vals3: a hashed-union copy
    for stage 1 (None: the flat union kernel over the primary). REQUIRES
    nonnegative weights (the caller's gate). n_union: the batch's distinct
    term count, which tightens the bound. A query of the batch whose proof
    fails sends the whole batch to the exact union kernel: the verdicts are
    read on the host once (`all(ok)`). Returns (scores, ids[, ok])."""
    n = doc_ids.shape[0]
    b, t = q_ids.shape
    k = min(k, n)
    k_scan = max(min(k_scan, n), k)
    ids2d = doc_ids.reshape(n, -1)
    vals2d = doc_vals.reshape(n, -1)
    if doc_ids3 is not None:
        s1, i1 = sparse_topk_union_hashed(doc_ids3, doc_vals3, q_ids, q_vals,
                                          k_scan, stage1=True)
    else:
        s1, i1 = sparse_topk_union(ids2d, vals2d, q_ids, q_vals, k_scan,
                                   stage1=True)
    u = float(b * t) if n_union is None else min(float(n_union),
                                                  float(b * t))
    rel = _twopass_rel_bound(u, t, ids2d.shape[1])
    cut = s1[:, k_scan - 1]
    bound = cut * (1.0 + rel)
    # candidates ascending (pads first), so the stable sort keeps the
    # scan's lower-id-first tie order
    cand = torch.sort(i1, dim=1).values
    scores = rescore_ell(ids2d, vals2d, q_ids, q_vals, cand)
    top_s, pos = _stable_topk(scores, k)
    top_i = torch.gather(cand, 1, pos).int()
    # a zero stage-1 cut is proven: with nonnegative weights a document
    # outside scores 0 exactly, and stage 1 already ranks zero ties
    # lowest id first
    kth = top_s[:, k - 1]
    ok = (kth > bound) | ((cut <= 0.0) & (kth <= 0.0))
    if not bool(ok.all()):
        if doc_ids3 is not None:
            top_s, top_i = sparse_topk_union_hashed(doc_ids3, doc_vals3,
                                                    q_ids, q_vals, k)
        else:
            top_s, top_i = sparse_topk_union(ids2d, vals2d, q_ids, q_vals, k)
    if return_ok:
        return top_s, top_i, ok
    return top_s, top_i


PLAIN = {
    "sparse_topk": sparse_topk_plain,
    "sparse_topk_hashed": sparse_topk_hashed_plain,
    "sparse_topk_union": sparse_topk_union_plain,
    "sparse_topk_union_hashed": sparse_topk_union_hashed_plain,
}
