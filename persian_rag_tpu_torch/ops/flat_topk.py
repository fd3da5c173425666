"""Flat top-k search: the two-stage exact regime, the running top-k
regimes, int8 candidate generation, and their plain references.

The counterpart of ``persian_rag_tpu.ops.flat_topk`` for the paths that
dense serving runs:

* ``flat_topk_ref`` — the materialized f32 scan (FAISS flat semantics);
* ``flat_topk_scan`` — the same, chunked over the corpus;
* ``flat_topk_exact2_stream`` — bf16 candidate extraction (stage 1,
  ``flat_topk_candidates``) -> exact f32 re-score of the finalists ->
  per-query residual proof -> f32 rescan of the 256-query slices whose
  proof failed. The result equals the f32 scan's by proof;
* ``flat_topk_scaled_candidates`` — candidate ids over int8 rows with
  per-row scales (the int8 tier's stage 1; the caller refines exactly);
* ``flat_topk_running`` — running top-k over f32, bf16 or row-scaled int8
  rows, k <= 128: modes ``exact``, ``fast`` (packed 21-bit scores),
  ``fasti`` and ``fastg`` (the fast lists by sorted insertion and by
  group-reduced extraction), and the ``maxonly`` floor;
* ``flat_topk`` — the regime dispatcher.

Stage 1 also takes the grouped / lane-sliced reduction (``group``,
``lane_slots``) and every kernel but bf16x2 the (d, N) corpus layout
(``corpus_transposed``).

Each kernel is hand-written CUDA (``csrc/flat_topk_candidates_bf16.cu``,
``csrc/flat_topk_candidates.cu``, ``csrc/flat_topk_candidates_x2.cu``,
``csrc/flat_topk_candidates_int8.cu``, ``csrc/flat_topk_running.cu``,
``csrc/flat_topk_running_select.cu``, ``csrc/flat_topk_maxonly.cu``) and
runs on
CUDA tensors; CPU tensors take its plain PyTorch version
(``flat_topk_candidates_plain``,
``flat_topk_running_plain``, ``flat_topk_running_insert_plain``,
``flat_topk_running_group_plain``, ``flat_topk_running_maxonly_plain``).
There is no fallback from one to the other. Every kernel of the dense
path takes any width d: where a block's shared memory does not hold its
queries' whole width, it stages them a window of K values at a time, each
chain still running k ascending from +0, so the bits do not depend on it.

Semantics kept from the JAX package:

* metric ``dot`` ranks by q.c descending; ``l2`` returns squared L2
  distances ascending, ranked in the maximize space 2 q.c - ||c||^2;
* equal scores prefer the lower corpus row (FAISS). JAX relied on
  ``lax.top_k`` being stable; ``torch.topk`` promises no order on ties, so
  every selection that can meet a tie here is a stable sort;
* every exact contraction runs in full f32 (`full_f32` turns TF32 off on
  the card), as the JAX package pinned ``Precision.HIGHEST``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -3.0e38
TWO_STAGE_MIN_N = 32_768
# corpus columns per stage-1 tile on the GPU: 1024 gives 98 tiles at 100k
# rows, so a 64-query batch still launches 392 blocks for 132 SMs
TWO_STAGE_TILE_N = 1024
PROOF_SLICE = 256
MATERIALIZE_BUDGET = 256 * 1024 * 1024

_COL_BITS = 11
_COL_MASK = (1 << _COL_BITS) - 1
_INT_MIN = -(1 << 31)
RUNNING_MAX_K = 128
# shared memory a block may ask for
_SMEM_LIMIT = 232_448
# shared memory of one SM of the H100, and what CUDA reserves per block
_SM_SMEM = 233_472
_BLOCK_SMEM_RESERVED = 1_024
# the int8 tier's candidate selection: keys per (query, tile) and tile rows
SCALED_TILE_N = 2048
SCALED_N_EASY = 7

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("float32", "bfloat16",
    "int8"; anything with such a `.name` or `str()`)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _DTYPES[name]

# the TF32 flags are process-wide: threads (the server's batch worker and
# its /rag handlers) take turns so none restores them under another
_F32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and convolutions in full float32 (TF32 off),
    restoring both PyTorch flags afterwards. The exact parts of the search
    (refine, fallback scans, centering matvec, commit probe) run under it:
    TF32 keeps ~10 mantissa bits, which would void the residual proof."""
    with _F32_LOCK:
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


def _topk_desc(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, score descending, lower position first on ties."""
    vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return torch.sum(x * x, dim=-1)


# ---------------------------------------------------------------------------
# Plain exact scans (the reference arithmetic, and the proof's fallback).
# ---------------------------------------------------------------------------


def _operands(queries, corpus, compute_dtype):
    """f32 operands of a contraction computed in `compute_dtype`: bf16
    compute rounds both to bf16 first (int8 rows are exact in bf16), and
    their products are then exact in f32."""
    if compute_dtype is not None and as_dtype(compute_dtype) == torch.bfloat16:
        return queries.bfloat16().float(), corpus.bfloat16().float()
    return queries.float(), corpus.float()


def flat_topk_ref(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    compute_dtype=None,
    corpus_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by full score materialization (O(Q*N) memory).
    corpus_scale: (N,) per-row scales of an int8 corpus, folded into the
    scores after the contraction."""
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric: {metric}")
    q, c = _operands(queries, corpus, compute_dtype)
    k = min(k, c.shape[0])
    with full_f32():
        scores = q @ c.T
    if corpus_scale is not None:
        scores = scores * corpus_scale.float()[None, :]
    if metric == "l2":
        # maximize s = 2 q.c - ||c||^2  <=>  minimize squared L2
        s = 2.0 * scores - _sqnorm(corpus)[None, :]
        top_s, top_i = _topk_desc(s, k)
        return _sqnorm(queries)[:, None] - top_s, top_i
    return _topk_desc(scores, k)


def flat_topk_scan(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    chunk: int = 16_384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 top-k over corpus chunks: memory bounded at Q x chunk
    (`flat_topk_running_plain` in exact mode and f32)."""
    return flat_topk_running_plain(queries, corpus, k, metric, chunk=chunk)


# ---------------------------------------------------------------------------
# Proof bounds and key packing (values identical to the JAX package's).
# ---------------------------------------------------------------------------


def _bf16_matmul_eps(d: int) -> float:
    """Rigorous relative bound on |bf16-matmul - exact| for a length-d
    dot product, in units of ||q||*||c||: bf16 inputs carry <= 2^-9 each,
    products are exact in f32, f32 accumulation adds <= (d-1) 2^-24 in any
    order; 25% slack."""
    return (2.0 ** -8 + 2.0 ** -18 + (d - 1) * 2.0 ** -24) * 1.25


def _bf16x2_matmul_eps(d: int) -> float:
    """Rigorous relative bound for the 3-term bf16x2 contraction: the
    dropped q_lo.c_lo term, the lo parts' own rounding, and f32
    accumulation over 3d products; 25% slack (see the CUDA kernel's note
    on one accumulation of 3d terms)."""
    return (3.0 * 2.0 ** -18 * (1 + 2.0 ** -9)
            + 3.0 * (d - 1) * 2.0 ** -24) * 1.25


def _score_to_ikey(s: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> int32: a > b  <=>  ikey(a) > ikey(b)."""
    i = s.float().contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _ikey_to_score(ikey: torch.Tensor) -> torch.Tensor:
    i = torch.where(ikey < 0, ikey ^ 0x7FFFFFFF, ikey)
    return i.contiguous().view(torch.float32)


def _exact_refine(q32, corpus, cand, csq, metric, k):
    """f32 re-score of candidate rows and top-k. cand is (Q, m) ids,
    id-ascending per row so the stable sort keeps FAISS lower-id tie
    order; -1 = pad. Returns scores in MAXIMIZE space."""
    safe = torch.clamp(cand, min=0)
    rows = corpus[safe].float()
    with full_f32():
        s_ref = torch.einsum("qd,qmd->qm", q32, rows)
    s_refm = 2.0 * s_ref - csq[safe] if metric == "l2" else s_ref
    s_refm = torch.where(cand >= 0, s_refm, torch.full_like(s_refm, NEG_INF))
    top_s, pos = _topk_desc(s_refm, k)
    return top_s, torch.gather(cand, 1, pos)


def _proof_eps(q32, csq, metric, max_cnorm_sq=None, eps_mm=None):
    """Per-query rigorous bound on |stage-1 score - true score|."""
    err_factor = 2.0 if metric == "l2" else 1.0
    q_norm = torch.sqrt(torch.sum(q32 * q32, dim=-1))
    if max_cnorm_sq is None:
        max_cnorm_sq = torch.max(csq)
    if eps_mm is None:
        eps_mm = _bf16_matmul_eps(q32.shape[1])
    return err_factor * eps_mm * q_norm * torch.sqrt(max_cnorm_sq)


# ---------------------------------------------------------------------------
# Stage 1: candidate extraction (CUDA kernels and their plain version).
# ---------------------------------------------------------------------------


def flat_topk_candidates_plain(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
    corpus_lo: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    group: int = 0,
    depth: int = 2,
    transposed: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the candidate kernels, on any device.

    Scores are bf16-rounded queries times the bf16 image, computed in f32
    (never a bf16-output matmul, which would round the scores); with
    corpus_lo, s = q_hi.c_hi + q_hi.c_lo + q_lo.c_hi. For l2 (corpus_sqnorm
    given) s = 2 s - ||c||^2. With corpus_scale the rows are int8 (exact
    in bf16) and s = scale * (q_hi.c). Returns the (Q, J, n_easy+1) int32
    slots: each tile's top n_easy packed keys, descending, then its bound.

    group > 0 is the grouped kernel: column g C + s of a tile (C = tile_n /
    group) is in slot s, each slot keeps its best `depth` keys, the ranks
    come from those and the bound is max(the (n_easy+1)-th of them, the
    deepest level's max). transposed: corpus_bf16 is stored (d, N)."""
    if transposed:
        corpus_bf16 = corpus_bf16.t().contiguous()
    q = queries.float()
    q_hi = q.bfloat16().float()
    c_hi = corpus_bf16.float()
    with full_f32():
        s = q_hi @ c_hi.T
        if corpus_lo is not None:
            q_lo = (q - q_hi).bfloat16().float()
            s = s + q_hi @ corpus_lo.float().T + q_lo @ c_hi.T
    if corpus_sqnorm is not None:
        s = 2.0 * s - corpus_sqnorm.float()[None, :]
    elif corpus_scale is not None:
        s = s * corpus_scale.float()[None, :]
    return _tile_slots(s, tile_n, n_easy, group, depth)


def _tile_slots(s: torch.Tensor, tile_n: int, n_easy: int, group: int = 0,
                depth: int = 2) -> torch.Tensor:
    """The (Q, J, n_easy+1) stage-1 slots of (Q, N) f32 scores s: each
    tile's top n_easy packed keys, descending, then its bound
    (`flat_topk_candidates_plain`'s contract)."""
    n_q, n = s.shape
    n_tiles = -(-n // tile_n)
    col = torch.arange(n, device=s.device, dtype=torch.int32) % tile_n
    key = (_score_to_ikey(s) & ~_COL_MASK) | (tile_n - 1 - col)[None, :]
    keys = torch.full(
        (n_q, n_tiles * tile_n), _INT_MIN, dtype=torch.int32, device=s.device
    )
    keys[:, :n] = key
    tiles = keys.view(n_q, n_tiles, tile_n)
    if not group:
        # keys are unique inside a tile (column bits): topk's tie order is
        # moot
        return torch.topk(tiles, n_easy + 1, dim=2).values
    slots = tile_n // group
    levels = min(depth, group)
    top = torch.topk(tiles.view(n_q, n_tiles, group, slots), levels,
                     dim=2).values  # (Q, J, levels, C), level-major
    reduced = top.reshape(n_q, n_tiles, levels * slots)
    if reduced.shape[2] < n_easy + 1:
        reduced = torch.cat([reduced, torch.full(
            (n_q, n_tiles, n_easy + 1 - reduced.shape[2]), _INT_MIN,
            dtype=torch.int32, device=s.device)], dim=2)
    ranks = torch.topk(reduced, n_easy + 1, dim=2).values
    deep = top[:, :, levels - 1].max(dim=2).values
    if depth > group:  # nothing is hidden behind the slots' lists
        deep = torch.full_like(deep, _INT_MIN)
    bound = torch.maximum(ranks[:, :, n_easy], deep)
    return torch.cat([ranks[:, :, :n_easy], bound[:, :, None]], dim=2)


def bf16x2_chain_scores(
    queries: torch.Tensor,
    corpus_hi: torch.Tensor,
    corpus_lo: torch.Tensor,
) -> torch.Tensor:
    """(Q, N) f32 stage-1 scores of the bf16x2 kernel, in its order: one f32
    chain from +0 a (query, row), k ascending, three products a k (q_hi
    c_hi, q_hi c_lo, q_lo c_hi; q_hi = bf16(q), q_lo = bf16(q - q_hi)), each
    added with one rounding to nearest. A product of two bf16 values is
    exact in f32, so a multiply and an add here are the kernel's fmaf, bit
    for bit, on any device. d steps over (Q, N) tensors: a mirror for
    checks, not a path."""
    q = queries.float()
    qh = q.bfloat16().float()
    ql = (q - qh).bfloat16().float()
    ch = corpus_hi.float().t().contiguous()  # (d, N): a k is one row
    cl = corpus_lo.float().t().contiguous()
    acc = torch.zeros((q.shape[0], ch.shape[1]), dtype=torch.float32,
                      device=q.device)
    for k in range(q.shape[1]):
        acc = acc + qh[:, k, None] * ch[k][None, :]
        acc = acc + qh[:, k, None] * cl[k][None, :]
        acc = acc + ql[:, k, None] * ch[k][None, :]
    return acc


def bf16x2_chain_candidates(
    queries: torch.Tensor,
    corpus_hi: torch.Tensor,
    corpus_lo: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
) -> torch.Tensor:
    """The (Q, J, n_easy+1) slots the bf16x2 kernel writes, from
    `bf16x2_chain_scores` (for l2, 2 s - ||c||^2 with one rounding): equal
    to the kernel's bit for bit."""
    s = bf16x2_chain_scores(queries, corpus_hi, corpus_lo)
    if corpus_sqnorm is not None:
        s = 2.0 * s - corpus_sqnorm.float()[None, :]
    return _tile_slots(s, tile_n, n_easy)


def _chain_scores(queries: torch.Tensor, rows_dn: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32: one f32 chain from +0 a (query, row), k ascending, of
    bf16(q_k) c_k over (d, N) rows whose values are exact in bf16, each
    product added with one rounding to nearest. Such a product is exact in
    f32, so a multiply and an add here are the kernels' fmaf, bit for bit,
    on any device. d steps over (Q, N) tensors: a mirror for checks, not a
    path."""
    qh = queries.float().bfloat16().float()
    c = rows_dn.float()
    acc = torch.zeros((qh.shape[0], c.shape[1]), dtype=torch.float32,
                      device=qh.device)
    for k in range(qh.shape[1]):
        acc = acc + qh[:, k, None] * c[k][None, :]
    return acc


def bf16_chain_scores(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    transposed: bool = False,
) -> torch.Tensor:
    """(Q, N) f32 stage-1 scores of the bf16 kernel (#1), in its order: one
    f32 chain from +0 a (query, row), k ascending, of bf16(q_k) c_k
    (`_chain_scores`). corpus_bf16 is (N, d), or (d, N) when transposed."""
    rows = corpus_bf16 if transposed else corpus_bf16.t()
    return _chain_scores(queries, rows.contiguous())


def bf16_chain_candidates(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
    transposed: bool = False,
) -> torch.Tensor:
    """The (Q, J, n_easy+1) slots the bf16 kernel writes, from
    `bf16_chain_scores` (for l2, 2 s - ||c||^2 with one rounding): equal to
    the kernel's bit for bit in either layout."""
    s = bf16_chain_scores(queries, corpus_bf16, transposed)
    if corpus_sqnorm is not None:
        s = 2.0 * s - corpus_sqnorm.float()[None, :]
    return _tile_slots(s, tile_n, n_easy)


def int8_chain_scores(
    queries: torch.Tensor,
    corpus_int8: torch.Tensor,
    corpus_scale: torch.Tensor,
) -> torch.Tensor:
    """(Q, N) f32 stage-1 scores of the int8 kernel, in its order: one f32
    chain from +0 a (query, row), k ascending, of bf16(q_k) c_k
    (`_chain_scores`: int8 values are exact in bf16), then one f32 multiply
    by the row's scale."""
    acc = _chain_scores(queries, corpus_int8.t().contiguous())
    return acc * corpus_scale.float()[None, :]


def int8_chain_candidates(
    queries: torch.Tensor,
    corpus_int8: torch.Tensor,
    corpus_scale: torch.Tensor,
    tile_n: int,
    n_easy: int,
) -> torch.Tensor:
    """The (Q, J, n_easy+1) slots the int8 kernel writes, from
    `int8_chain_scores`: equal to the kernel's bit for bit."""
    return _tile_slots(int8_chain_scores(queries, corpus_int8, corpus_scale),
                       tile_n, n_easy)


def grouped_chain_candidates(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    corpus_scale: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
    group: int,
    depth: int,
    transposed: bool = False,
) -> torch.Tensor:
    """The (Q, J, n_easy+1) slots the grouped kernel (#3) writes, from its
    chain (bf16 rows: `bf16_chain_scores`, for l2 2 s - ||c||^2 with one
    rounding; int8 rows: `int8_chain_scores`, the row scale with one
    rounding): equal to the kernel's bit for bit in either layout. Keys
    in a tile are unique, so the slot table does not depend on the order
    the kernel merges them in: this reduces each tile at once
    (`_tile_slots`)."""
    if corpus_scale is not None:
        rows = corpus.t() if transposed else corpus
        s = int8_chain_scores(queries, rows.contiguous(), corpus_scale)
    else:
        s = bf16_chain_scores(queries, corpus, transposed)
        if corpus_sqnorm is not None:
            s = 2.0 * s - corpus_sqnorm.float()[None, :]
    return _tile_slots(s, tile_n, n_easy, group, depth)


def running_chain_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    mode: str = "exact",
    transposed: bool = False,
    rows_per_seg: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lists modes exact and fast (#5, #6) return under bf16 compute,
    from the chain they compute: one f32 chain from +0 a (query, row), k
    ascending, of bf16(q_k) bf16(c_k) (`_chain_scores`: such a product is
    exact in f32, so this is the kernel's fmaf chain bit for bit), the row
    scale or the l2 map with one rounding each, the unique keys (score
    order << 32 | ~id; exact folds -0 into +0, fast keeps the top 21 bits
    of the int key) and a stable descending sort of them. With
    rows_per_seg, each segment's top k first, then the sort of their union,
    as the kernel's segments and the merge do: the same lists. Returns what
    `flat_topk_running` returns: (Q, k) scores (squared distances for l2)
    and int64 ids. d steps over (Q, N) tensors: a mirror for checks, not a
    path."""
    corpus, cn = _running_args(corpus, metric, corpus_sqnorm, corpus_scale,
                               transposed)
    n = corpus.shape[0]
    k = min(k, n)
    s = _chain_scores(queries, corpus.bfloat16().float().t().contiguous())
    if corpus_scale is not None:
        s = s * corpus_scale.float()[None, :]
    if metric == "l2":
        s = 2.0 * s - cn.float()[None, :]
    fast = _RUNNING_MODES[mode] == "fast"
    if not fast:
        s = torch.where(s == 0, torch.zeros_like(s), s)  # -0 -> +0
    ikey = _score_to_ikey(s)
    if fast:
        ikey = ikey & ~_COL_MASK
    ids = torch.arange(n, device=s.device, dtype=torch.int64)
    keys = ikey.long() * (1 << 32) + (0xFFFFFFFF - ids)[None, :]
    if rows_per_seg is not None:
        keys = torch.cat([
            torch.topk(keys[:, a: a + rows_per_seg],
                       min(k, keys[:, a: a + rows_per_seg].shape[1]),
                       dim=1).values
            for a in range(0, n, rows_per_seg)], dim=1)
    top = torch.sort(keys, dim=1, descending=True, stable=True).values[:, :k]
    scores = _ikey_to_score((top >> 32).int())
    top_i = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    if metric == "l2":
        scores = _sqnorm(queries.float().contiguous())[:, None] - scores
    return scores, top_i


class X2Geometry(NamedTuple):
    """The launch of a part-and-merge stage-1 kernel (bf16
    `prt_extract_candidates_bf16`, bf16x2 `prt_extract_candidates_bf16x2`,
    int8 `prt_extract_candidates_int8`):
    `queries` a block, `rows` of a tile a block, `parts` blocks a tile
    (merged by a second kernel when more than one), `blocks` in all,
    `threads` a block, `smem` bytes of shared memory a block."""
    queries: int
    rows: int
    parts: int
    blocks: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=256)
def _stream_geometry(name: str, n_q: int, n: int, d: int,
                     tile_n: int) -> X2Geometry:
    """The launch that stage-1 kernel `name` makes, as its C entry
    `prt_extract_candidates_<name>_geometry` reports it (the same choice
    that picks the launch). Any d; raises ValueError past the tile and grid
    limits."""
    from persian_rag_tpu_torch.ops import _build

    lib = _build.load()
    geo = (ctypes.c_int * 6)()
    entry = getattr(lib, f"prt_extract_candidates_{name}_geometry")
    if entry(n_q, n, d, tile_n, geo) != 0:
        raise ValueError(
            f"the {name} kernel takes tile_n <= 2048 in steps of 32 and at "
            f"most 65,535 tiles: got Q={n_q}, N={n}, d={d}, tile_n={tile_n}")
    return X2Geometry(*geo)


def bf16_geometry(n_q: int, n: int, d: int, tile_n: int) -> X2Geometry:
    """The launch that the bf16 kernel (#1) makes for Q queries of width d
    over N rows in tiles of tile_n (`prt_extract_candidates_bf16_geometry`).
    Raises ValueError past the kernel's limits."""
    return _stream_geometry("bf16", n_q, n, d, tile_n)


def bf16x2_geometry(n_q: int, n: int, d: int, tile_n: int) -> X2Geometry:
    """The launch that the bf16x2 kernel makes
    (`prt_extract_candidates_bf16x2_geometry`). Raises ValueError past the
    kernel's limits."""
    return _stream_geometry("bf16x2", n_q, n, d, tile_n)


def int8_geometry(n_q: int, n: int, d: int, tile_n: int) -> X2Geometry:
    """The launch that the int8 kernel makes
    (`prt_extract_candidates_int8_geometry`). Raises ValueError past the
    kernel's limits."""
    return _stream_geometry("int8", n_q, n, d, tile_n)


class GroupedGeometry(NamedTuple):
    """The launch of the grouped stage 1 (#3, `prt_extract_candidates_grouped`):
    `queries` a block, `blocks` in all (query blocks times tiles), `window`
    K values of a block's query window (d rounded up to whole 64-byte
    slabs where the whole width fits), `windows` the windows a chunk of rows
    walks, `smem` bytes of shared memory a block."""
    queries: int
    blocks: int
    window: int
    windows: int
    smem: int


def grouped_smem(d: int, elem_bytes: int, qb: int, tile_n: int, group: int,
                 depth: int) -> Tuple[int, int]:
    """(shared memory bytes, query-window slabs) of a #3 block at qb queries
    (`grouped_smem` of csrc/grouped_candidates.cuh): the queries' window,
    f32 k-major, of whole 64-byte slabs of a row (all of d's where they
    fit, else the most that fit, spread evenly: `window_slabs`), the ring
    and the key table, qb x min(depth, group) x tile_n / group int32;
    (0, 0) where not one slab of queries fits beside the ring and the
    table."""
    kse = _SLAB_BYTES // elem_bytes
    slab = kse * (qb + 4) * 4
    rest = (_STREAM_STAGES[qb] * _STREAM_ROWS * _SLAB_STRIDE
            + qb * min(depth, group) * (tile_n // group) * 4)
    if rest + slab > _SMEM_LIMIT:
        return 0, 0
    slabs = _window_slabs(-(-d // kse), slab, rest)
    return slabs * slab + rest, slabs


@functools.lru_cache(maxsize=256)
def grouped_geometry(n_q: int, n: int, d: int, tile_n: int, group: int,
                     depth: int, elem_bytes: int, sms: int) -> GroupedGeometry:
    """The launch of #3 over rows of elem_bytes (2 bf16, 1 int8): a block
    keeps one (query block, tile), since the slot reduction needs a whole
    tile, and two blocks share an SM where shared memory lets them (the
    merges of one block's row halves take turns; on the H100, measured by
    scripts/grouped_qb.py, two blocks of 16 queries an SM beat one of 32
    at the lane pick, 64.2 against 70.4 ms, and with two an SM 32 beat 16
    at Q = 512, 1.297 against 1.550). The query
    block by Q (32 above 16 queries, 8 up to 8, else 16); 16 in place of
    32 where the whole width does not let two blocks share an SM; halved
    while the grid holds fewer blocks than the `sms` SMs (Q = 16 over 100k
    rows at tile 1,024: 98 tiles, so 8 queries); halved where not one slab
    of queries fits (`grouped_smem`; `prt_grouped_geometry` reports the C
    side). Raises ValueError when not even 8 queries' table fits."""
    if group < 1 or tile_n % group or depth < 1:
        raise ValueError(f"group must divide tile_n={tile_n} and depth be "
                         f">= 1: got group={group}, depth={depth}")
    kse = _SLAB_BYTES // elem_bytes
    slabs = -(-d // kse)
    n_tiles = -(-n // tile_n)
    qb = min(32, _stream_queries(n_q))
    smem, window = grouped_smem(d, elem_bytes, 32, tile_n, group, depth)
    if qb == 32 and (window < slabs or 2 * (
            smem + _BLOCK_SMEM_RESERVED) > _SM_SMEM):
        qb = 16
    while qb > 8 and -(-n_q // qb) * n_tiles < sms:
        qb //= 2
    while qb > 8 and not grouped_smem(d, elem_bytes, qb, tile_n, group,
                                      depth)[1]:
        qb //= 2
    smem, window = grouped_smem(d, elem_bytes, qb, tile_n, group, depth)
    if not window:
        raise ValueError(
            f"the grouped kernel's key table (8 x min(depth, group) x "
            f"tile_n / group keys at tile_n={tile_n}, group={group}, depth="
            f"{depth}) leaves no room for a slab of queries in "
            f"{_SMEM_LIMIT} bytes")
    return GroupedGeometry(
        queries=qb, blocks=-(-n_q // qb) * n_tiles, window=window * kse,
        windows=-(-slabs // window), smem=smem)


def _check_kernel_inputs(queries, corpus, row_values, corpus_lo=None,
                         dtypes=(torch.bfloat16,), transposed=False):
    """Raise on what the kernels do not take: queries (Q, d) f32, corpus
    (and corpus_lo) (N, d) (or, transposed, (d, N)) of one of `dtypes`,
    row_values (sqnorms or scales) (N,) f32 or None; all contiguous CUDA
    tensors on one device."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise ValueError("queries must be a (Q, d) float32 tensor")
    n_q, d = queries.shape
    parts = [("corpus", corpus)]
    if corpus_lo is not None:
        parts.append(("corpus_lo", corpus_lo))
    d_axis = 0 if transposed else 1
    shape = f"({d}, N)" if transposed else f"(N, {d})"
    for name, c in parts:
        if c.dtype not in dtypes or c.dim() != 2 or c.shape[d_axis] != d:
            raise ValueError(f"{name} must be {shape} of {dtypes}")
        if c.shape != corpus.shape or c.dtype != corpus.dtype:
            raise ValueError(f"{name} shape {tuple(c.shape)} != corpus shape")
    tensors = [queries] + [c for _, c in parts]
    if row_values is not None:
        if row_values.dtype != torch.float32 or row_values.shape != (
            corpus.shape[1 - d_axis],
        ):
            raise ValueError("per-row sqnorms / scales must be (N,) float32")
        tensors.append(row_values)
    for t in tensors:
        if t.device != dev:
            raise ValueError("all kernel inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError("kernel inputs must be 4-byte aligned")


def _launch_candidates(queries, corpus_bf16, corpus_sqnorm, tile_n, n_easy,
                       corpus_lo, corpus_scale=None, transposed=False,
                       group=0, depth=2):
    from persian_rag_tpu_torch.ops import _build

    if corpus_scale is not None:
        _check_kernel_inputs(queries, corpus_bf16, corpus_scale,
                             dtypes=(torch.int8,), transposed=transposed)
    else:
        _check_kernel_inputs(queries, corpus_bf16, corpus_sqnorm, corpus_lo,
                             transposed=transposed)
    lib = _build.load()
    n_q, d = queries.shape
    n = corpus_bf16.shape[1 if transposed else 0]
    scratch = None
    # each geometry raises past its kernel's limits
    if group:
        qb = grouped_geometry(n_q, n, d, tile_n, group, depth,
                              corpus_bf16.element_size(),
                              _sm_count(queries.device)).queries
    else:
        geo = (bf16x2_geometry if corpus_lo is not None
               else int8_geometry if corpus_scale is not None
               else bf16_geometry)(n_q, n, d, tile_n)
        if geo.parts > 1:  # each part's lists, for the merge of a tile
            scratch = torch.empty(
                (n_q, -(-n // tile_n), geo.parts, n_easy + 1),
                dtype=torch.int32, device=queries.device)
    out = torch.empty(
        (n_q, -(-n // tile_n), n_easy + 1), dtype=torch.int32,
        device=queries.device,
    )
    cn = corpus_sqnorm.data_ptr() if corpus_sqnorm is not None else None
    trans = int(transposed)
    # the launch goes to the CUDA context current on this thread
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        if group:
            rv = corpus_scale if corpus_scale is not None else corpus_sqnorm
            err = lib.prt_extract_candidates_grouped(
                queries.data_ptr(), corpus_bf16.data_ptr(),
                rv.data_ptr() if rv is not None else None, out.data_ptr(),
                n_q, n, d, tile_n, n_easy, group, depth,
                int(corpus_scale is not None), trans, qb, stream,
            )
        elif corpus_scale is not None:
            err = lib.prt_extract_candidates_int8(
                queries.data_ptr(), corpus_bf16.data_ptr(),
                corpus_scale.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                out.data_ptr(), n_q, n, d, tile_n, n_easy, trans, stream,
            )
        elif corpus_lo is None:
            err = lib.prt_extract_candidates_bf16(
                queries.data_ptr(), corpus_bf16.data_ptr(), cn,
                scratch.data_ptr() if scratch is not None else None,
                out.data_ptr(), n_q, n, d, tile_n, n_easy, trans, stream,
            )
        else:
            err = lib.prt_extract_candidates_bf16x2(
                queries.data_ptr(), corpus_bf16.data_ptr(),
                corpus_lo.data_ptr(), cn,
                scratch.data_ptr() if scratch is not None else None,
                out.data_ptr(), n_q, n, d, tile_n, n_easy, stream,
            )
    _build.check(lib, err, "candidate-extraction kernel launch")
    return out


def extract_candidates_bf16_cuda(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
    transposed: bool = False,
) -> torch.Tensor:
    """CUDA kernel for `_extract_candidates_kernel`'s contract (bf16
    stage 1). Same inputs and (Q, J, n_easy+1) int32 output as
    `flat_topk_candidates_plain`: a register-blocked stream whose keys equal
    `bf16_chain_candidates`' in either layout (`bf16_geometry` gives its
    launch). `launches` counts its launches."""
    out = _launch_candidates(
        queries, corpus_bf16, corpus_sqnorm, tile_n, n_easy, None,
        transposed=transposed,
    )
    extract_candidates_bf16_cuda.launches += 1
    return out


def extract_candidates_bf16x2_cuda(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    corpus_lo: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
) -> torch.Tensor:
    """CUDA kernel for `_extract_candidates_x2_kernel`'s contract (bf16x2
    stage 1: hi/lo split scores), a register-blocked stream whose keys equal
    `bf16x2_chain_candidates`' (`bf16x2_geometry` gives its launch).
    `launches` counts its launches."""
    out = _launch_candidates(
        queries, corpus_bf16, corpus_sqnorm, tile_n, n_easy, corpus_lo
    )
    extract_candidates_bf16x2_cuda.launches += 1
    return out


def extract_candidates_int8_cuda(
    queries: torch.Tensor,
    corpus_int8: torch.Tensor,
    corpus_scale: torch.Tensor,
    tile_n: int,
    n_easy: int,
    transposed: bool = False,
) -> torch.Tensor:
    """CUDA kernel for `_extract_candidates_kernel` with `row_scaled` over
    int8 rows (the int8 tier's candidate generation): s = scale * (bf16(q)
    . c), dot metric only; a register-blocked stream whose keys equal
    `int8_chain_candidates`' in either layout (`int8_geometry` gives its
    launch). `launches` counts its launches."""
    out = _launch_candidates(
        queries, corpus_int8, None, tile_n, n_easy, None, corpus_scale,
        transposed=transposed,
    )
    extract_candidates_int8_cuda.launches += 1
    return out


def extract_candidates_grouped_cuda(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_sqnorm: Optional[torch.Tensor],
    corpus_scale: Optional[torch.Tensor],
    tile_n: int,
    n_easy: int,
    group: int,
    depth: int,
    transposed: bool = False,
) -> torch.Tensor:
    """CUDA kernel for `_extract_candidates_grouped_kernel`'s contract
    (group = G is depth 2) and the lane-sliced branch of
    `_extract_candidates_kernel` (lane_slots = S, lane_depth = D is group
    S, depth D): bf16 rows (corpus_sqnorm for l2) or int8 rows with
    corpus_scale. Same (Q, J, n_easy+1) output as
    `flat_topk_candidates_plain(group=, depth=)`: a register-blocked stream
    whose keys equal `grouped_chain_candidates`' in either layout
    (`grouped_geometry` gives its launch). `launches` counts its
    launches."""
    out = _launch_candidates(
        queries, corpus, corpus_sqnorm, tile_n, n_easy, None, corpus_scale,
        transposed=transposed, group=group, depth=depth,
    )
    extract_candidates_grouped_cuda.launches += 1
    return out


extract_candidates_bf16_cuda.launches = 0
extract_candidates_bf16x2_cuda.launches = 0
extract_candidates_int8_cuda.launches = 0
extract_candidates_grouped_cuda.launches = 0


def flat_topk_candidates(
    queries: torch.Tensor,
    corpus_bf16: torch.Tensor,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    tile_n: int = TWO_STAGE_TILE_N,
    n_easy: int = 4,
    corpus_lo: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    group: int = 0,
    lane_slots: int = 0,
    lane_depth: int = 2,
    corpus_transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Stage-1 candidate extraction over the bf16 image, or, with
    corpus_scale ((N,) per-row scales, dot only), over int8 rows.

    Returns (cand_keys (Q, J*n_easy), bound_keys (Q, J), tile_n) in
    MAXIMIZE space: packed int32 keys whose high 21 bits are the
    quantized stage-1 score and low 11 bits the reversed column in the
    tile. Global row id = tile * tile_n + (tile_n - 1 - (key & mask)).
    Every element not among a tile's candidates has key <= the tile's
    bound key. corpus_lo selects the bf16x2 variant.

    group > 0 reduces each tile to its per-slot best two over `group` rows
    (column g * tile_n / group + s is in slot s) before extracting, with a
    weaker bound: max(the reduced keys left, the second level's max).
    lane_slots > 0 (when group is 0) is the same reduction keeping
    lane_depth keys per slot. corpus_transposed: the corpus is stored
    (d, N). bf16x2 takes neither, as in the JAX package.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise); any other device raises.
    """
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric: {metric}")
    n = corpus_bf16.shape[1 if corpus_transposed else 0]
    tile_n = min(tile_n, -(-n // 128) * 128)
    if not 0 < tile_n <= 1 << _COL_BITS:
        raise ValueError(f"tile_n must be in (0, {1 << _COL_BITS}]")
    if not 0 < n_easy < 8:
        raise ValueError("n_easy must be in [1, 7]")
    slots, depth = (group, 2) if group else (lane_slots, lane_depth)
    if slots:
        if slots < 0 or tile_n % slots:
            raise ValueError(f"tile_n={tile_n} is not a multiple of "
                             f"group / lane_slots={slots}")
        if depth < 1:
            raise ValueError(f"lane_depth must be >= 1, got {depth}")
    if corpus_lo is not None and (slots or corpus_transposed):
        raise ValueError("the bf16x2 stage 1 takes neither group / lane "
                         "slicing nor the (d, N) layout")
    cn = scale = None
    if metric == "l2":
        if corpus_sqnorm is None:
            raise ValueError("l2 needs corpus_sqnorm (||c||^2 of the rows)")
        cn = corpus_sqnorm.float().contiguous()
    if corpus_scale is not None:
        if metric != "dot" or corpus_lo is not None:
            raise ValueError("row scales serve the dot metric, without "
                             "corpus_lo")
        scale = corpus_scale.float().contiguous()
    q = queries.float().contiguous()
    dev = q.device.type
    if dev == "cpu":
        out = flat_topk_candidates_plain(
            q, corpus_bf16, cn, tile_n, n_easy, corpus_lo, scale,
            group=slots, depth=depth, transposed=corpus_transposed,
        )
    elif dev == "cuda":
        if slots:
            out = extract_candidates_grouped_cuda(
                q, corpus_bf16, cn, scale, tile_n, n_easy, slots, depth,
                corpus_transposed,
            )
        elif scale is not None:
            out = extract_candidates_int8_cuda(
                q, corpus_bf16, scale, tile_n, n_easy, corpus_transposed
            )
        elif corpus_lo is None:
            out = extract_candidates_bf16_cuda(
                q, corpus_bf16, cn, tile_n, n_easy, corpus_transposed
            )
        else:
            out = extract_candidates_bf16x2_cuda(
                q, corpus_bf16, corpus_lo, cn, tile_n, n_easy
            )
    else:
        raise ValueError(f"no candidate kernel for device type {dev}")
    cand_keys = out[:, :, :n_easy].reshape(q.shape[0], -1)
    bound_keys = out[:, :, n_easy]
    return cand_keys, bound_keys, tile_n


def _candidate_ids(cand_keys, k_scan, tile_n, n_easy):
    """The k_scan best of (Q, J*n_easy) candidate keys, by a stable sort,
    and the global row ids they decode to (-1 for an empty slot)."""
    top_keys, pos = _topk_desc(cand_keys, k_scan)
    ids = (pos // n_easy) * tile_n + (
        tile_n - 1 - (top_keys & _COL_MASK)).long()
    ids = torch.where(top_keys == _INT_MIN, torch.full_like(ids, -1), ids)
    return top_keys, ids


def flat_topk_scaled_candidates(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_scale: torch.Tensor,
    k_scan: int,
    tile_n: int = SCALED_TILE_N,
    n_easy: int = SCALED_N_EASY,
) -> torch.Tensor:
    """Candidate ids over a row-scaled int8 corpus: one merge-free pass
    (`flat_topk_candidates` with corpus_scale) and one small stable top-k
    over its keys. Returns (Q, k_scan) ids, -1 padded.

    Selection is capped at n_easy candidates per (query, tile): a true
    candidate is lost only when n_easy rows of its own tile beat it on the
    int8 score. The caller re-ranks exactly (`DenseIndex` refine); a caller
    that needs the exact int8-score order uses `flat_topk_running`."""
    cand_keys, _, tn = flat_topk_candidates(
        queries.float(), corpus, metric="dot", corpus_scale=corpus_scale,
        tile_n=tile_n, n_easy=n_easy,
    )
    k_scan = min(k_scan, cand_keys.shape[1])
    return _candidate_ids(cand_keys, k_scan, tn, n_easy)[1]


# ---------------------------------------------------------------------------
# Running top-k (CUDA kernels and their plain version).
# ---------------------------------------------------------------------------

_RUNNING_MODES = {"exact": "exact", "exactns": "exact",
                  "fast": "fast", "fastns": "fast", "fasti": "fasti",
                  "fastg": "fastg", "maxonly": "maxonly"}
# the modes that return a top-k list (maxonly returns each query's best
# score and no ids)
SEARCH_MODES = ("exact", "exactns", "fast", "fastns", "fasti", "fastg",
                "scan")
# the most keys one merge block sorts: 2,048 keys (groups of 2,048 / k
# lists a block, then one more level) took the merge of 66 lists of k = 128
# from 0.26 to 0.087 ms on the H100 against one block of 16,384 a query
_MERGE_SLOTS = 2_048
# fasti / fastg / maxonly: rows per tile of a segment's walk (the kernels'
# kSegTile), candidates per tile before the residual check (the JAX
# dispatcher's n_easy), and fastg's rows per reduced slot
_SEG_TILE = 256
_SEG_N_EASY = 4
_SEG_GROUP = 16
_EMPTY = torch.iinfo(torch.int64).min


def _plain_scores(queries, rows, metric, cn, scale, compute_dtype):
    """f32 scores of `rows` in maximize space, as the running kernels
    define them (the plain versions' shared arithmetic)."""
    q, c = _operands(queries, rows, compute_dtype)
    with full_f32():
        s = q @ c.T
    if scale is not None:
        s = s * scale.float()[None, :]
    if metric == "l2":
        s = 2.0 * s - cn.float()[None, :]
    return s


def _running_args(corpus, metric, corpus_sqnorm, corpus_scale, transposed):
    """The (N, d) rows and the per-row values a plain version reads."""
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric: {metric}")
    if corpus_scale is not None and metric == "l2":
        raise ValueError("int8 row scales support dot/cosine only")
    if transposed:
        corpus = corpus.t().contiguous()
    cn = None
    if metric == "l2":
        cn = _sqnorm(corpus) if corpus_sqnorm is None else corpus_sqnorm
    return corpus, cn


def flat_topk_running_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    mode: str = "exact",
    chunk: int = 16_384,
    transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the running top-k kernels, on any device:
    a running best over corpus chunks, memory bounded at Q x chunk.

    The running results precede each chunk's columns (ascending ids) in a
    stable descending sort, so equal scores keep the lower id: the order
    `merge_topk` produces by taking the lowest position among tied maxima.
    mode "fast" ranks by the packed keys ikey(s) & ~0x7FF (scores truncated
    to their top 21 bits) and returns the truncated scores. corpus_scale:
    (N,) per-row scales of int8 rows (dot only); corpus_sqnorm: ||c||^2
    for l2, derived from the rows when None. compute_dtype bf16 rounds
    both operands to bf16 before the f32 contraction. transposed: the
    corpus is stored (d, N)."""
    corpus, cn = _running_args(corpus, metric, corpus_sqnorm, corpus_scale,
                               transposed)
    fast = _RUNNING_MODES[mode] == "fast"
    n = corpus.shape[0]
    k = min(k, n)
    n_q, dev = queries.shape[0], queries.device
    run_s = torch.empty(
        (n_q, 0), dtype=torch.int32 if fast else torch.float32, device=dev)
    run_i = torch.empty((n_q, 0), dtype=torch.long, device=dev)
    for start in range(0, n, chunk):
        end = start + chunk
        s = _plain_scores(
            queries, corpus[start:end], metric,
            None if cn is None else cn[start:end],
            None if corpus_scale is None else corpus_scale[start:end],
            compute_dtype)
        if fast:
            s = _score_to_ikey(s) & ~_COL_MASK
        top_s, top_i = _topk_desc(s, min(k, s.shape[1]))
        cand_s = torch.cat([run_s, top_s], dim=1)
        cand_i = torch.cat([run_i, top_i + start], dim=1)
        run_s, pos = _topk_desc(cand_s, k)
        run_i = torch.gather(cand_i, 1, pos)
    if fast:
        run_s = _ikey_to_score(run_s)
    if metric == "l2":
        run_s = _sqnorm(queries)[:, None] - run_s
    return run_s, run_i


def _run_keys(tile_keys, start):
    """Running keys (int64: truncated score << 32 | 2^32 - 1 - id, so a
    larger key is a better row, lower id first on a truncated tie; _EMPTY
    where the tile key is INT_MIN) of packed keys of the tile at `start`."""
    ids = start + (_SEG_TILE - 1 - (tile_keys & _COL_MASK)).long()
    run = (tile_keys & ~_COL_MASK).long() * (1 << 32) + (0xFFFFFFFF - ids)
    return torch.where(tile_keys == _INT_MIN, torch.full_like(run, _EMPTY),
                       run)


def _could_enter(rest, kth):
    """Whether a tile key `rest` bounding the tile's unlisted rows could
    enter a list whose k-th running key is kth (`could_enter` of
    csrc/flat_topk_running.cu)."""
    return (rest != _INT_MIN) & ((kth == _EMPTY) | (rest.long() > (kth >> 32)))


def _tile_skips(keys, run):
    """The queries whose tile cannot change their list: the tile's best key
    could not enter it (`could_enter` false), so every insert is a no-op
    and every merge returns the list itself. The kernels skip such a
    (query, tile), and so do the plain versions."""
    return ~_could_enter(keys.max(dim=1).values, run[:, -1])


def _insert_sorted(run, b):
    """Insert one running key per row into descending lists (no-op where
    b is at or below the last entry): `insert_sorted` of the kernel."""
    pos = (run > b[:, None]).sum(dim=1, keepdim=True)
    idx = torch.arange(run.shape[1], device=run.device)[None, :]
    shifted = torch.cat([run[:, :1], run[:, :-1]], dim=1)
    return torch.where(idx < pos, run,
                       torch.where(idx == pos, b[:, None], shifted))


def _merge_sorted(run, cand):
    """The top len(run) of two lists of unique running keys."""
    return torch.sort(torch.cat([run, cand], dim=1), dim=1,
                      descending=True).values[:, : run.shape[1]]


def _tile_walk_plain(queries, corpus, k, metric, corpus_sqnorm, corpus_scale,
                     compute_dtype, transposed, step):
    """Walk the corpus in tiles of _SEG_TILE rows, in order: `step(run,
    keys, start)` updates the (Q, k) running keys with the tile's packed
    keys (INT_MIN past N). Returns the lists decoded as the kernels'
    merge does (truncated scores, l2 mapped back)."""
    corpus, cn = _running_args(corpus, metric, corpus_sqnorm, corpus_scale,
                               transposed)
    n = corpus.shape[0]
    k = min(k, n)
    n_q, dev = queries.shape[0], queries.device
    run = torch.full((n_q, k), _EMPTY, dtype=torch.long, device=dev)
    col = torch.arange(_SEG_TILE, device=dev, dtype=torch.int32)
    for start in range(0, n, _SEG_TILE):
        end = min(start + _SEG_TILE, n)
        s = _plain_scores(
            queries, corpus[start:end], metric,
            None if cn is None else cn[start:end],
            None if corpus_scale is None else corpus_scale[start:end],
            compute_dtype)
        keys = torch.full((n_q, _SEG_TILE), _INT_MIN, dtype=torch.int32,
                          device=dev)
        keys[:, : end - start] = (
            (_score_to_ikey(s) & ~_COL_MASK)
            | (_SEG_TILE - 1 - col[: end - start])[None, :])
        run = step(run, keys, start)
    scores = _ikey_to_score((run >> 32).int())
    ids = 0xFFFFFFFF - (run & 0xFFFFFFFF)
    empty = run == _EMPTY
    scores = torch.where(empty, torch.full_like(scores, NEG_INF), scores)
    ids = torch.where(empty, torch.full_like(ids, -1), ids)
    if metric == "l2":
        scores = _sqnorm(queries)[:, None] - scores
    return scores, ids


def flat_topk_running_insert_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    transposed: bool = False,
    n_easy: int = _SEG_N_EASY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fasti kernel (`_fast_insert_topk_kernel`
    's mechanism): per tile of 256 rows, n_easy ranks inserted into the
    sorted list one by one; where the best key left could still enter, the
    following ranks too. A rank past N (INT_MIN) is never inserted; a query
    whose tile cannot enter its list skips it (`_tile_skips`). The lists
    equal mode "fast"'s."""

    def step(run, keys, start):
        kk = run.shape[1]
        easy = min(n_easy, kk)
        skip = _tile_skips(keys, run)[:, None]
        before = run
        ranks = torch.topk(keys, min(keys.shape[1], easy + kk), dim=1).values
        # a rank past N is _EMPTY as a running key: inserting it is a no-op
        for e in range(easy):
            run = _insert_sorted(run, _run_keys(ranks[:, e], start))
        if easy < kk:
            need = _could_enter(ranks[:, easy], run[:, kk - 1])
            if bool(need.any()):
                for r in range(easy, ranks.shape[1]):
                    run = torch.where(need[:, None], _insert_sorted(
                        run, _run_keys(ranks[:, r], start)), run)
        return torch.where(skip, before, run)

    return _tile_walk_plain(queries, corpus, k, metric, corpus_sqnorm,
                            corpus_scale, compute_dtype, transposed, step)


def flat_topk_running_group_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    transposed: bool = False,
    n_easy: int = _SEG_N_EASY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fastg kernel (`_fast_group_topk_kernel`
    's mechanism): per tile of 256 rows, the per-slot top 2 over 16 rows
    (column mod 16), n_easy ranks from those 32 keys merged into the list;
    where max(keys left, max of the second level) could still enter the
    new list, the tile's raw ranks merged against the pre-merge list; a
    query whose tile cannot enter its list skips it (`_tile_skips`). The
    lists equal mode "fast"'s."""
    slots = _SEG_TILE // _SEG_GROUP

    def step(run, keys, start):
        kk = run.shape[1]
        easy = min(n_easy, kk)
        n_q = keys.shape[0]
        top2 = torch.topk(keys.view(n_q, _SEG_GROUP, slots), 2, dim=1).values
        reduced = top2.reshape(n_q, 2 * slots)
        ranks = torch.topk(reduced, easy + 1, dim=1).values
        bound = torch.maximum(ranks[:, easy], top2[:, 1].max(dim=1).values)
        new = _merge_sorted(run, _run_keys(ranks[:, :easy], start))
        need = _could_enter(bound, new[:, kk - 1])
        if bool(need.any()):
            raw = torch.topk(keys, min(kk, keys.shape[1]), dim=1).values
            full = _merge_sorted(run, _run_keys(raw, start))
            new = torch.where(need[:, None], full, new)
        return torch.where(_tile_skips(keys, run)[:, None], run, new)

    return _tile_walk_plain(queries, corpus, k, metric, corpus_sqnorm,
                            corpus_scale, compute_dtype, transposed, step)


def flat_topk_running_maxonly_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    chunk: int = 16_384,
    transposed: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the maxonly kernel (`_max_only_kernel`'s
    floor): each query's largest score in maximize space, (Q,) f32, over
    the real rows and with the row scales folded in."""
    corpus, cn = _running_args(corpus, metric, corpus_sqnorm, corpus_scale,
                               transposed)
    best = torch.full((queries.shape[0],), float("-inf"),
                      device=queries.device)
    for start in range(0, corpus.shape[0], chunk):
        end = start + chunk
        s = _plain_scores(
            queries, corpus[start:end], metric,
            None if cn is None else cn[start:end],
            None if corpus_scale is None else corpus_scale[start:end],
            compute_dtype)
        best = torch.maximum(best, s.max(dim=1).values)
    return best


def _merge_running(lib, keys, k, stream):
    """prt_running_merge levels over (Q, lists, k) keys until one list per
    query is left, decoded: maximize-space scores (Q, k) f32 and ids (Q, k)
    int32."""
    from persian_rag_tpu_torch.ops import _build

    n_q, lists = keys.shape[0], keys.shape[1]
    dev = keys.device
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=dev)
    group = _MERGE_SLOTS // k
    while lists > group:
        merged = torch.empty(
            (n_q, -(-lists // group), k), dtype=torch.int64, device=dev)
        err = lib.prt_running_merge(
            keys.data_ptr(), merged.data_ptr(), None, None, n_q, lists,
            k, group, _MERGE_SLOTS, stream,
        )
        _build.check(lib, err, "running top-k merge kernel launch")
        keys, lists = merged, merged.shape[1]
    seg = 1 << max(lists * k - 1, 1).bit_length()
    err = lib.prt_running_merge(
        keys.data_ptr(), None, out_s.data_ptr(), out_i.data_ptr(), n_q,
        lists, k, lists, seg, stream,
    )
    _build.check(lib, err, "running top-k merge kernel launch")
    return out_s, out_i


def _running_setup(queries, corpus, row_values, transposed):
    """Checks shared by the running launches; returns (lib, n, corpus type
    code)."""
    from persian_rag_tpu_torch.ops import _build

    _check_kernel_inputs(
        queries, corpus, row_values,
        dtypes=(torch.float32, torch.bfloat16, torch.int8),
        transposed=transposed,
    )
    if queries.shape[0] > 65_535:
        raise ValueError(f"the running top-k kernels take at most 65,535 "
                         f"queries per call, got {queries.shape[0]}")
    corpus_type = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[
        corpus.dtype]
    return _build.load(), corpus.shape[1 if transposed else 0], corpus_type


def _launch_running(queries, corpus, row_values, cn_mode, k, bf16_compute,
                    fast, transposed=False):
    """Both passes of modes exact and fast: each segment's top-k keys
    (`csrc/flat_topk_running_select.cu`, at `running_geometry`), then merge
    levels until one list per query is left (`csrc/flat_topk_running.cu`).
    Returns maximize-space scores (Q, k) f32 and ids (Q, k) int32."""
    from persian_rag_tpu_torch.ops import _build

    lib, n, corpus_type = _running_setup(queries, corpus, row_values,
                                         transposed)
    n_q, d = queries.shape
    dev = queries.device
    geo = running_geometry(n_q, n, d, k, corpus.element_size(),
                           _sm_count(dev))
    keys = torch.empty((n_q, geo.n_seg, k), dtype=torch.int64, device=dev)
    rv = row_values.data_ptr() if row_values is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prt_running_tile_topk(
            queries.data_ptr(), corpus.data_ptr(), rv, keys.data_ptr(), n_q,
            n, d, k, corpus_type, cn_mode, int(bf16_compute), int(fast),
            int(transposed), geo.qb, geo.qcap, geo.rows_per_seg, stream,
        )
        _build.check(lib, err, "running top-k select kernel launch")
        return _merge_running(lib, keys, k, stream)


def _launch_segment(queries, corpus, row_values, cn_mode, k, bf16_compute,
                    mode, transposed=False):
    """The segment kernel (`csrc/segment_topk.cuh`, at `segment_geometry`):
    mode 0 (fasti) and 1 (fastg) return maximize-space scores (Q, k) f32
    and ids (Q, k) int32 after merging the segments' lists."""
    from persian_rag_tpu_torch.ops import _build

    lib, n, corpus_type = _running_setup(queries, corpus, row_values,
                                         transposed)
    n_q, d = queries.shape
    dev = queries.device
    geo = segment_geometry(n_q, n, d, k, corpus.element_size(), mode,
                           _sm_count(dev))
    out = torch.empty((n_q, geo.n_seg, k), dtype=torch.int64, device=dev)
    rv = row_values.data_ptr() if row_values is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.prt_running_segment(
            queries.data_ptr(), corpus.data_ptr(), rv, out.data_ptr(), n_q,
            n, d, k, corpus_type, cn_mode, int(bf16_compute),
            int(transposed), mode, _SEG_N_EASY, geo.qb, geo.rows_per_seg,
            stream,
        )
        _build.check(lib, err, "running top-k segment kernel launch")
        return _merge_running(lib, out, k, stream)


# the stream of maxonly, exact and fast (`stream_rows` of
# csrc/row_stream.cuh): a block holds 64, 32, 16 or 8 queries k-major in
# shared memory (a k's stride 4 floats more), a window of K values at a time
# past what fits, and streams chunks of 256 rows through a ring of 3 (fewer
# than 64 queries: 2) stages of 64 bytes a row (a row's stride 80 bytes);
# maxonly keeps two row halves' maxima of its queries
_STREAM_STAGES = {64: 3, 32: 2, 16: 2, 8: 2}
_SLAB_BYTES, _SLAB_STRIDE, _STREAM_ROWS = 64, 80, 256


class MaxonlyGeometry(NamedTuple):
    """One launch of `prt_running_maxonly`: `qb` queries per block,
    `rows_per_seg` rows per segment (whole 256-row tiles), `n_seg`
    segments, `blocks` (query blocks times segments) and the block's
    shared memory `smem` in bytes."""
    qb: int
    rows_per_seg: int
    n_seg: int
    blocks: int
    smem: int


def maxonly_smem(d: int, elem_bytes: int, qb: int) -> int:
    """Shared memory of a maxonly block (`maxonly_smem` of the kernel):
    the queries' window, f32 k-major, of whole 64-byte slabs of a row (all
    of d's slabs where they fit, else the most that fit, spread evenly:
    `window_slabs`), the ring and the two row halves' maxima."""
    kse = _SLAB_BYTES // elem_bytes
    slab = kse * (qb + 4) * 4
    rest = _STREAM_STAGES[qb] * _STREAM_ROWS * _SLAB_STRIDE + 2 * qb * 4
    return _window_slabs(-(-d // kse), slab, rest) * slab + rest


def _window_slabs(slabs: int, slab: int, rest: int) -> int:
    """The slabs of a query window (`window_slabs` of csrc/row_stream.cuh):
    all of them where they fit beside `rest` bytes, else the most that fit,
    spread evenly over the windows."""
    fit = (_SMEM_LIMIT - rest) // slab
    return slabs if slabs <= fit else -(-slabs // -(-slabs // fit))


def maxonly_geometry(n_q: int, n: int, d: int, elem_bytes: int,
                     sms: int) -> MaxonlyGeometry:
    """The launch geometry of #9: 64 queries per block where their whole
    width fits shared memory, else 32 (staged a window at a time past what
    fits: any d), and segments of whole 256-row tiles, enough (query block,
    segment) blocks to fill the `sms` SMs as many times as a block's shared
    memory lets them hold."""
    kse = _SLAB_BYTES // elem_bytes
    whole = -(-d // kse) * kse * (64 + 4) * 4 + (
        _STREAM_STAGES[64] * _STREAM_ROWS * _SLAB_STRIDE + 2 * 64 * 4)
    qb = 64 if whole <= _SMEM_LIMIT else 32
    smem = maxonly_smem(d, elem_bytes, qb)
    per_sm = max(1, _SM_SMEM // (smem + _BLOCK_SMEM_RESERVED))
    q_blocks = -(-n_q // qb)
    n_tiles = -(-n // _SEG_TILE)
    want = -(-sms * per_sm // q_blocks)
    per = -(-n_tiles // max(1, min(n_tiles, want)))
    n_seg = -(-n_tiles // per)
    return MaxonlyGeometry(qb=qb, rows_per_seg=per * _SEG_TILE, n_seg=n_seg,
                           blocks=q_blocks * n_seg, smem=smem)


class RunningGeometry(NamedTuple):
    """One launch of `prt_running_tile_topk` (modes exact and fast): `qb`
    queries a block, `qcap` keys a query's queue, `slabs` 64-byte slabs of
    K values in a block's query window (all of d's where they fit),
    `rows_per_seg` rows a segment (whole 256-row chunks), `n_seg`
    segments, `blocks` (query blocks times segments), `per_sm` blocks an SM
    holds at once, and the block's shared memory `smem` in bytes."""
    qb: int
    qcap: int
    slabs: int
    rows_per_seg: int
    n_seg: int
    blocks: int
    per_sm: int
    smem: int


def running_smem(d: int, elem_bytes: int, qb: int, k: int) -> Tuple[int, int]:
    """(shared memory bytes, query-window slabs) of an exact / fast block
    (`running_smem` of csrc/flat_topk_running_select.cu): the queries'
    window, f32 k-major, of whole 64-byte slabs of a row (all of d's where
    they fit, else the most that fit, spread evenly: `window_slabs`), the
    ring, qb lists of k keys, qb queues and a warp's sorted queue of k
    rounded up to 32 keys, qb thresholds and the two row halves' queue
    counts."""
    kse = _SLAB_BYTES // elem_bytes
    slab = kse * (qb + 4) * 4
    qcap = -(-k // 32) * 32
    rest = (_STREAM_STAGES[qb] * _STREAM_ROWS * _SLAB_STRIDE
            + (qb * k + qb * qcap + 8 * qcap + qb) * 8 + 2 * qb * 4)
    slabs = _window_slabs(-(-d // kse), slab, rest)
    return slabs * slab + rest, slabs


def _stream_queries(n_q: int) -> int:
    """The query block of the register streams by Q alone
    (`stream_cand_queries`): 64 above 32 queries, 32 above 16, 8 up to 8,
    else 16."""
    if n_q > 32:
        return 64
    if n_q > 16:
        return 32
    return 8 if n_q <= 8 else 16


@functools.lru_cache(maxsize=16)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=256)
def running_geometry(n_q: int, n: int, d: int, k: int, elem_bytes: int,
                     sms: int) -> RunningGeometry:
    """The launch geometry of #5 / #6: the query block by Q (64 above 32
    queries, 32 above 16, 8 up to 8, else 16), 32 in place of 64 where the
    whole width does not fit beside k's lists and queues (so at k = 100 and
    d = 384); then segments of whole 256-row chunks (`_segment_split`), as
    many rows a segment as keep the waves of blocks over the `sms` SMs
    shortest."""
    if not 1 <= k <= RUNNING_MAX_K:
        raise ValueError(f"k must be in [1, {RUNNING_MAX_K}], got {k}")
    qb = _stream_queries(n_q)
    kse = _SLAB_BYTES // elem_bytes
    if qb == 64 and running_smem(d, elem_bytes, 64, k)[1] < -(-d // kse):
        qb = 32
    smem, slabs = running_smem(d, elem_bytes, qb, k)
    per_sm, per, n_seg = _segment_split(-(-n_q // qb), n, qb, smem, sms)
    return RunningGeometry(
        qb=qb, qcap=-(-k // 32) * 32, slabs=slabs,
        rows_per_seg=per * _STREAM_ROWS, n_seg=n_seg,
        blocks=-(-n_q // qb) * n_seg, per_sm=per_sm, smem=smem)


def _segment_split(q_blocks: int, n: int, qb: int, smem: int,
                   sms: int) -> Tuple[int, int, int]:
    """(blocks an SM, chunks a segment, segments) of a segmented stream
    (#5 / #6, #7 / #8): as many blocks an SM as shared memory holds, at
    most one of 32 or 64 queries and two of 16 or 8 (which the kernels'
    launch bounds give the registers of); segments of whole 256-row chunks,
    as many rows a segment as keep the waves of blocks over the `sms` SMs
    shortest: the fewest waves times chunks a block, ties to fewer
    segments."""
    per_sm = max(1, min(1 if qb >= 32 else 2,
                        _SM_SMEM // (smem + _BLOCK_SMEM_RESERVED)))
    n_chunks = -(-n // _STREAM_ROWS)
    resident = sms * per_sm
    best = None
    for per in range(1, n_chunks + 1):
        if best is not None and per > best[0]:
            break  # a wave of `per` chunks costs more already
        n_seg = -(-n_chunks // per)
        if n_seg > 65_535:
            continue
        cost = -(-q_blocks * n_seg // resident) * per
        if best is None or cost <= best[0]:
            best = (cost, per, n_seg)
    return per_sm, best[1], best[2]


class SegmentGeometry(NamedTuple):
    """One launch of `prt_running_segment` (modes fasti and fastg): `qb`
    queries a block, `slabs` 64-byte slabs of K values in a block's query
    window (all of d's where they fit), `rows_per_seg` rows a segment
    (whole 256-row tiles), `n_seg` segments, `blocks` (query blocks times
    segments), `per_sm` blocks an SM holds at once, and the block's shared
    memory `smem` in bytes."""
    qb: int
    slabs: int
    rows_per_seg: int
    n_seg: int
    blocks: int
    per_sm: int
    smem: int


def segment_smem(d: int, elem_bytes: int, qb: int, k: int,
                 mode: int) -> Tuple[int, int]:
    """(shared memory bytes, query-window slabs) of a fasti (mode 0) /
    fastg (mode 1) block (`segment_smem` of csrc/segment_topk.cuh): the
    queries' window, f32 k-major, of whole 64-byte slabs of a row (all of
    d's where they fit, else the most that fit, spread evenly:
    `window_slabs`), the ring, the key tile of a 256-row tile (qb x 256
    int32) and qb lists of k keys (fastg: three); (0, 0) where not one
    slab of queries fits beside the rest."""
    kse = _SLAB_BYTES // elem_bytes
    slab = kse * (qb + 4) * 4
    rest = (_STREAM_STAGES[qb] * _STREAM_ROWS * _SLAB_STRIDE
            + qb * _SEG_TILE * 4 + (1 if mode == 0 else 3) * qb * k * 8)
    if rest + slab > _SMEM_LIMIT:
        return 0, 0
    slabs = _window_slabs(-(-d // kse), slab, rest)
    return slabs * slab + rest, slabs


@functools.lru_cache(maxsize=256)
def segment_geometry(n_q: int, n: int, d: int, k: int, elem_bytes: int,
                     mode: int, sms: int) -> SegmentGeometry:
    """The launch geometry of #7 (mode 0) / #8 (mode 1): the query block by
    Q (64 above 32 queries, 32 above 16, 8 up to 8, else 16), 32 in place
    of 64 where the whole width does not fit beside the key tile and the
    lists (so at d = 384 over int8 rows), halved where not one slab of
    queries fits (fastg's three lists at k = 128: 32 queries); then
    segments of whole 256-row tiles as `running_geometry`'s
    (`_segment_split`)."""
    if not 1 <= k <= RUNNING_MAX_K:
        raise ValueError(f"k must be in [1, {RUNNING_MAX_K}], got {k}")
    qb = _stream_queries(n_q)
    kse = _SLAB_BYTES // elem_bytes
    if qb == 64 and segment_smem(d, elem_bytes, 64, k, mode)[1] < -(-d // kse):
        qb = 32
    while qb > 8 and not segment_smem(d, elem_bytes, qb, k, mode)[1]:
        qb //= 2
    smem, slabs = segment_smem(d, elem_bytes, qb, k, mode)
    per_sm, per, n_seg = _segment_split(-(-n_q // qb), n, qb, smem, sms)
    return SegmentGeometry(
        qb=qb, slabs=slabs, rows_per_seg=per * _STREAM_ROWS, n_seg=n_seg,
        blocks=-(-n_q // qb) * n_seg, per_sm=per_sm, smem=smem)


def _launch_maxonly(queries, corpus, row_values, cn_mode, bf16_compute,
                    transposed=False):
    """`prt_running_maxonly`: each query's best maximize-space score (Q,)
    f32."""
    from persian_rag_tpu_torch.ops import _build

    lib, n, corpus_type = _running_setup(queries, corpus, row_values,
                                         transposed)
    n_q, d = queries.shape
    dev = queries.device
    geo = maxonly_geometry(
        n_q, n, d, corpus.element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.full((n_q,), _INT_MIN, dtype=torch.int32, device=dev)
    rv = row_values.data_ptr() if row_values is not None else None
    with torch.cuda.device(dev):
        err = lib.prt_running_maxonly(
            queries.data_ptr(), corpus.data_ptr(), rv, out.data_ptr(), n_q,
            n, d, corpus_type, cn_mode, int(bf16_compute), int(transposed),
            geo.qb, geo.rows_per_seg,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "maxonly kernel launch")
    return _ikey_to_score(out)


def flat_topk_running_exact_cuda(queries, corpus, row_values, cn_mode, k,
                                 bf16_compute, transposed=False):
    """CUDA kernels for `_topk_kernel`'s contract (exact running top-k):
    scores in maximize space, lowest id first on exact ties. row_values:
    (N,) f32 sqnorms (cn_mode 1), row scales (cn_mode 2) or None (0).
    `launches` counts its launches."""
    out = _launch_running(queries, corpus, row_values, cn_mode, k,
                          bf16_compute, False, transposed)
    flat_topk_running_exact_cuda.launches += 1
    return out


def flat_topk_running_fast_cuda(queries, corpus, row_values, cn_mode, k,
                                bf16_compute, transposed=False):
    """CUDA kernels for `_fast_topk_kernel`'s contract (packed-key running
    top-k: scores truncated to their top 21 bits, lower id first on
    truncated ties). `launches` counts its launches."""
    out = _launch_running(queries, corpus, row_values, cn_mode, k,
                          bf16_compute, True, transposed)
    flat_topk_running_fast_cuda.launches += 1
    return out


def flat_topk_running_insert_cuda(queries, corpus, row_values, cn_mode, k,
                                  bf16_compute, transposed=False):
    """CUDA kernels for `_fast_insert_topk_kernel` (mode "fasti": #6's
    lists by sorted insertion into segment lists on the register stream,
    then the merge; `segment_geometry` gives its launch). `launches`
    counts its launches."""
    out = _launch_segment(queries, corpus, row_values, cn_mode, k,
                          bf16_compute, 0, transposed)
    flat_topk_running_insert_cuda.launches += 1
    return out


def flat_topk_running_group_cuda(queries, corpus, row_values, cn_mode, k,
                                 bf16_compute, transposed=False):
    """CUDA kernels for `_fast_group_topk_kernel` (mode "fastg": #6's lists
    by group-reduced extraction into segment lists on the register stream,
    then the merge; `segment_geometry` gives its launch). `launches`
    counts its launches."""
    out = _launch_segment(queries, corpus, row_values, cn_mode, k,
                          bf16_compute, 1, transposed)
    flat_topk_running_group_cuda.launches += 1
    return out


def flat_topk_running_maxonly_cuda(queries, corpus, row_values, cn_mode,
                                   bf16_compute, transposed=False):
    """CUDA kernel for `_max_only_kernel` (mode "maxonly"): each query's
    best maximize-space score (Q,) f32 over the real rows, row scales
    folded in. `launches` counts its launches."""
    out = _launch_maxonly(queries, corpus, row_values, cn_mode,
                          bf16_compute, transposed)
    flat_topk_running_maxonly_cuda.launches += 1
    return out


flat_topk_running_exact_cuda.launches = 0
flat_topk_running_fast_cuda.launches = 0
flat_topk_running_insert_cuda.launches = 0
flat_topk_running_group_cuda.launches = 0
flat_topk_running_maxonly_cuda.launches = 0

_RUNNING_KERNELS = {
    "exact": flat_topk_running_exact_cuda,
    "fast": flat_topk_running_fast_cuda,
    "fasti": flat_topk_running_insert_cuda,
    "fastg": flat_topk_running_group_cuda,
}
_RUNNING_PLAIN = {
    "fasti": flat_topk_running_insert_plain,
    "fastg": flat_topk_running_group_plain,
}


def flat_topk_running(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    mode: str = "exact",
    corpus_transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k search (the JAX package's `flat_topk_pallas`).

    Returns (scores, ids), each (Q, k), k <= 128: squared distances
    ascending for l2, inner products descending for dot. Modes "exact",
    "fast", "fasti" and "fastg" ("exactns" / "fastns" are the same
    results; the three fast modes return the same lists by different
    kernels); "maxonly" returns each query's best score in every column
    and ids -1 (a floor, not a search). corpus_scale: (N,) per-row scales
    of an int8 corpus (dot only); corpus_transposed: the corpus is stored
    (d, N). CPU tensors take the plain versions; CUDA tensors launch the
    kernels (or raise)."""
    if mode not in _RUNNING_MODES:
        raise ValueError(f"unknown mode: {mode}")
    if metric not in ("dot", "l2"):
        raise ValueError(f"unknown metric: {metric}")
    if corpus_scale is not None and metric == "l2":
        raise ValueError("int8 row scales support dot/cosine only")
    kind = _RUNNING_MODES[mode]
    k = min(k, corpus.shape[1 if corpus_transposed else 0])
    if not 1 <= k <= RUNNING_MAX_K:
        raise ValueError(f"k must be in [1, {RUNNING_MAX_K}], got {k}")
    dev = queries.device.type
    if dev == "cpu":
        args = (corpus_sqnorm, corpus_scale, compute_dtype)
        if kind == "maxonly":
            best = flat_topk_running_maxonly_plain(
                queries, corpus, metric, *args, transposed=corpus_transposed)
        elif kind in _RUNNING_PLAIN:
            return _RUNNING_PLAIN[kind](queries, corpus, k, metric, *args,
                                        transposed=corpus_transposed)
        else:
            return flat_topk_running_plain(
                queries, corpus, k, metric, *args, mode,
                transposed=corpus_transposed)
    elif dev == "cuda":
        q = queries.float().contiguous()
        row_values, cn_mode = None, 0
        if metric == "l2":
            # derived as from (N, d) rows, so both layouts give equal bits
            cn = (_sqnorm(corpus.t().contiguous() if corpus_transposed
                          else corpus)
                  if corpus_sqnorm is None else corpus_sqnorm)
            row_values, cn_mode = cn.float().contiguous(), 1
        elif corpus_scale is not None:
            row_values, cn_mode = corpus_scale.float().contiguous(), 2
        bf16 = as_dtype(compute_dtype) == torch.bfloat16
        c = corpus.contiguous()
        if kind == "maxonly":
            best = flat_topk_running_maxonly_cuda(
                q, c, row_values, cn_mode, bf16, corpus_transposed)
        else:
            top_s, top_i = _RUNNING_KERNELS[kind](
                q, c, row_values, cn_mode, k, bf16, corpus_transposed)
            if metric == "l2":
                top_s = _sqnorm(q)[:, None] - top_s
            return top_s, top_i.long()
    else:
        raise ValueError(f"no running top-k kernel for device type {dev}")
    # maxonly: each query's best score in every column, and no ids
    top_s = best[:, None].expand(-1, k).clone()
    if metric == "l2":
        top_s = _sqnorm(queries.float())[:, None] - top_s
    return top_s, torch.full(top_s.shape, -1, dtype=torch.long,
                             device=top_s.device)


# ---------------------------------------------------------------------------
# The two-stage exact regime.
# ---------------------------------------------------------------------------


def flat_topk_exact2_stream(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    k_scan: int = 32,
    tile_n: int = TWO_STAGE_TILE_N,
    n_easy: int = 4,
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_bf16: Optional[torch.Tensor] = None,
    return_ok: bool = False,
    corpus_center: Optional[torch.Tensor] = None,
    center_sqmax: Optional[torch.Tensor] = None,
    corpus_bf16_lo: Optional[torch.Tensor] = None,
    group: int = 0,
    lane_slots: int = 0,
    lane_depth: int = 2,
    bf16_transposed: bool = False,
):
    """Bit-exact top-k: bf16 candidate extraction -> one small top-k over
    the candidate keys -> f32 refine -> per-query residual proof.

    Exactness, per query: every corpus element is a finalist (re-scored
    in f32), a non-finalist candidate (key <= the k_scan-th finalist key)
    or unextracted (key <= its tile's bound key). So every non-finalist's
    true score is at most bump(value(max(bound keys, k_scan-th key))) plus
    the stage-1 rounding bound, with bump(v) = v + |v| 2^-11 for the key's
    truncated low bits. A query whose refined k-th score strictly exceeds
    that is proven; each 256-query slice holding an unproven query is
    rescanned in f32, so the result always equals the f32 scan's.

    corpus_center: (d,) row mean of a MEAN-CENTERED stage-1 image
    (corpus_bf16 then holds bf16(c - mu)); the bound is translated back by
    <q, mu> (2<q, mu> for l2) and the rounding term uses the centered
    norms (center_sqmax = max ||c - mu||^2). corpus_bf16_lo: bf16 residues
    of the stage-1 rows, selecting the bf16x2 stage 1 and its ~100x
    tighter bound.

    group / lane_slots / lane_depth select the grouped or lane-sliced
    stage 1 (`flat_topk_candidates`): a weaker per-tile bound, which the
    proof absorbs or pays a rescan for. bf16_transposed: corpus_bf16 is
    stored (d, N) (derived so when not given).

    return_ok=True also returns the per-query verdict as a CPU bool
    tensor (the fallback branch has read it to the host already). A False
    entry does not mean an inexact result: that query's slice paid for
    the f32 rescan.
    """
    n_q, d = queries.shape
    q32 = queries.float().contiguous()

    if corpus_bf16 is not None:
        c16 = corpus_bf16
    else:
        src = corpus
        if corpus_center is not None:
            src = src.float() - corpus_center.float()[None, :]
        # a bf16-stored corpus is its own stage-1 image
        c16 = src.bfloat16()
        c16 = (c16.t() if bf16_transposed else c16).contiguous()
    csq = (
        corpus_sqnorm.float() if corpus_sqnorm is not None
        else _sqnorm(corpus)
    )
    cand_keys, bound_keys, tn = flat_topk_candidates(
        q32, c16, metric=metric,
        corpus_sqnorm=csq if metric == "l2" else None,
        tile_n=tile_n, n_easy=n_easy, corpus_lo=corpus_bf16_lo,
        group=group, lane_slots=lane_slots, lane_depth=lane_depth,
        corpus_transposed=bf16_transposed,
    )
    k_scan = min(k_scan, cand_keys.shape[1])
    if k > k_scan:
        raise ValueError(f"k={k} exceeds k_scan={k_scan}")

    top_keys, ids = _candidate_ids(cand_keys, k_scan, tn, n_easy)

    # residual bound over everything outside the finalists (maximize space)
    bound_key = torch.maximum(
        torch.max(bound_keys, dim=1).values, top_keys[:, k_scan - 1]
    )
    bound_val = _ikey_to_score(bound_key & ~_COL_MASK)
    bound_val = bound_val + torch.abs(bound_val) * 2.0 ** -11

    cand = torch.sort(ids, dim=1).values  # -1 sentinels first, id-ascending
    top_s, top_i = _exact_refine(q32, corpus, cand, csq, metric, k)

    eps_mm = _bf16x2_matmul_eps(d) if corpus_bf16_lo is not None else None
    if corpus_center is not None:
        # keys live in centered space: translate the bound by <q, mu>, in
        # full f32 (the translation is a proof input), and fold that
        # matvec's own accumulation bound into eps
        mu32 = corpus_center.float()
        with full_f32():
            qc = q32 @ mu32
        err_f = 2.0 if metric == "l2" else 1.0
        bound_val = bound_val + err_f * qc
        mu_norm = torch.sqrt(torch.sum(mu32 * mu32))
        if center_sqmax is None:
            # rigorous fallback: ||c - mu|| <= ||c|| + ||mu||
            max_cn = (torch.sqrt(torch.max(csq)) + mu_norm) ** 2
        else:
            max_cn = center_sqmax
        eps = _proof_eps(q32, csq, metric, max_cnorm_sq=max_cn,
                         eps_mm=eps_mm)
        q_norm = torch.sqrt(torch.sum(q32 * q32, dim=-1))
        eps = eps + err_f * (d - 1) * 2.0 ** -24 * q_norm * mu_norm
    else:
        eps = _proof_eps(q32, csq, metric, eps_mm=eps_mm)
    ok_q = top_s[:, k - 1] > bound_val + eps

    if metric == "l2":
        top_s = _sqnorm(q32)[:, None] - top_s

    # the one host read the control flow needs: which slices to rescan
    ok_host = ok_q.cpu()
    if not bool(ok_host.all()):
        ok_np = ok_host.numpy()
        n = corpus.shape[0]
        top_s = top_s.clone()
        top_i = top_i.clone()
        for start in range(0, n_q, PROOF_SLICE):
            if ok_np[start : start + PROOF_SLICE].all():
                continue
            q_i = q32[start : start + PROOF_SLICE]
            # bit-parity with flat_topk_ref while the slice's score block
            # fits the materialization budget; stream beyond it
            if q_i.shape[0] * n * 4 <= MATERIALIZE_BUDGET:
                s_i, i_i = flat_topk_ref(q_i, corpus, k, metric=metric)
            else:
                s_i, i_i = flat_topk_scan(q_i, corpus, k, metric=metric)
            top_s[start : start + PROOF_SLICE] = s_i
            top_i[start : start + PROOF_SLICE] = i_i
    if return_ok:
        return top_s, top_i, ok_host
    return top_s, top_i


def flat_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "dot",
    corpus_sqnorm: Optional[torch.Tensor] = None,
    corpus_scale: Optional[torch.Tensor] = None,
    corpus_bf16: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    mode: str = "exact",
    corpus_center: Optional[torch.Tensor] = None,
    center_sqmax: Optional[torch.Tensor] = None,
    corpus_bf16_lo: Optional[torch.Tensor] = None,
    return_ok: bool = False,
):
    """Dispatching entry point, in the JAX package's regime order. Every
    regime takes the same route on CPU and CUDA tensors: the kernels on
    CUDA tensors, their plain versions on CPU tensors.

    * mode "scan": the chunked f32 scan (margin-free corpora).
    * k > 128: the materialized `flat_topk_ref`.
    * Two-stage regime when N >= TWO_STAGE_MIN_N, k <= 32, no row scales,
      mode exact/fast and (mode fast or f32 compute). The corpus may be
      stored in f32 or bf16; a bf16 corpus without corpus_bf16 is its own
      stage-1 image, and the refine runs on the stored rows.
    * Materialized `flat_topk_ref` for mode exact, f32 compute, no row
      scales, when the Q*N*4-byte score block fits MATERIALIZE_BUDGET.
    * Otherwise `flat_topk_running`: row-scaled int8 scores, bf16 compute,
      mode fast below the two-stage gate, modes fasti, fastg and maxonly,
      32 < k <= 128 or a small N past the budget.

    Every kernel takes any width d (a block stages its queries a window
    of K values at a time past what its shared memory holds), so no regime
    depends on d.

    corpus_sqnorm / corpus_bf16 are serving caches (the two-stage regime;
    corpus_sqnorm also the running l2 kernels); other regimes derive what
    they need from `corpus`. return_ok=True appends the two-stage per-query
    proof verdict, or None when another regime served the call.
    """
    n = corpus.shape[0]
    k = min(k, n)

    def _no_ok(out):
        return out + (None,) if return_ok else out

    if mode == "scan":
        return _no_ok(flat_topk_scan(queries, corpus, k, metric=metric))
    if k > RUNNING_MAX_K:
        return _no_ok(flat_topk_ref(
            queries, corpus, k, metric=metric, corpus_scale=corpus_scale))
    f32_compute = as_dtype(compute_dtype) == torch.float32
    if (
        corpus_scale is None
        and mode in ("exact", "fast")
        and (mode == "fast" or f32_compute)
        and k <= 32
        and n >= TWO_STAGE_MIN_N
    ):
        return flat_topk_exact2_stream(
            queries, corpus, k, metric=metric, k_scan=max(32, 2 * k),
            tile_n=TWO_STAGE_TILE_N, n_easy=4, corpus_sqnorm=corpus_sqnorm,
            corpus_bf16=corpus_bf16, return_ok=return_ok,
            corpus_center=corpus_center, center_sqmax=center_sqmax,
            corpus_bf16_lo=corpus_bf16_lo,
        )
    if (
        mode == "exact"
        and corpus_scale is None
        and f32_compute
        and queries.shape[0] * n * 4 <= MATERIALIZE_BUDGET
    ):
        return _no_ok(flat_topk_ref(
            queries, corpus, k, metric=metric, compute_dtype=compute_dtype))
    return _no_ok(flat_topk_running(
        queries, corpus, k, metric=metric, corpus_sqnorm=corpus_sqnorm,
        corpus_scale=corpus_scale, compute_dtype=compute_dtype, mode=mode,
    ))
