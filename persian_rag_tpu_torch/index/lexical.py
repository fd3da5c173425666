"""Lexical indexes: BM25 (Okapi) and TF-IDF, device-resident.

The counterpart of ``persian_rag_tpu.index.lexical`` on one device:

* BM25 reproduces rank_bm25's ``BM25Okapi`` (k1=1.5, b=0.75, idf
  ln((N-df+0.5)/(df+0.5)), negative idfs replaced by epsilon * mean idf);
* TF-IDF reproduces scikit-learn's ``TfidfVectorizer(max_features=10000,
  ngram_range=(1, 2))``: smooth idf, l2-normalised rows and queries, so
  cosine == dot.

Every per-(doc, term) contribution is computed at build time into a padded
ELL (doc-length buckets of widths 16 * 2^i). The builders produce the JAX
package's arrays bit for bit: its Python loops, vectorised here with the
same float64 operations in the same order. A search encodes the queries on
the host, picks the kernel per batch with the JAX package's gates (the
union gate, the hashed-layout gates and the hashed-union work model, whose
constants are TPU-measured crossovers carried over unchanged), runs every
bucket's top-k on the index's device (``ops.sparse_scores``) and merges the
buckets there by (score descending, global id ascending).

``BM25Index.build`` takes the native builder (``native/lexical_native.cpp``,
compiled with g++ at first use) where it builds, as the JAX package does.
``two_pass="auto"`` serves union batches past the ``_TWOPASS_*`` gates
through stage 1 of the union kernels, an exact rescore and a proof
(``ops.sparse_scores.sparse_topk_union_twopass``), demoted for the build
after ``TWOPASS_DEMOTE_STREAK`` dispatches whose queries mostly failed the
proof. ``prefilter="fast"`` / ``"verified"`` serve through the hashed-UB
prefilter (``ops.lexical_prefilter``).

With a `mesh` (``core.mesh``) every ELL (the flat one, or each bucket's)
shards over the mesh's corpus axis, each shard in the device layout the
single-device gates pick for its rows, and a search goes through
``parallel.sharded_lexical.sharded_sparse_topk``; buckets then merge by
(score descending, global id ascending) on the mesh's first device, the
index's device. The prefilter and two-pass serving stay single-device, as
in the JAX package.
"""
from __future__ import annotations

import json
import logging
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device, to_host
from persian_rag_tpu_torch.core.mesh import CORPUS_AXIS, check_mesh
from persian_rag_tpu_torch.ops.lexical_prefilter import (
    assign_buckets,
    build_ub_image,
    hash_queries,
    prefilter_topk,
)
from persian_rag_tpu_torch.parallel.sharded_search import merge_by_score_id
from persian_rag_tpu_torch.ops.sparse_scores import (
    hash_segments,
    sparse_scores_ref,
    sparse_topk,
    sparse_topk_hashed,
    sparse_topk_union,
    sparse_topk_union_hashed,
    sparse_topk_union_twopass,
)

_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")

logger = logging.getLogger(__name__)


def whitespace_tokenize(text: str) -> List[str]:
    """The reference's BM25 tokenization (str.split)."""
    return text.split()


def sklearn_analyzer(text: str, ngram_range: Tuple[int, int] = (1, 2)) -> List[str]:
    """sklearn TfidfVectorizer's default analyzer: lowercase word
    tokens (>=2 chars), plus space-joined n-grams."""
    tokens = _TOKEN_RE.findall(text.lower())
    lo, hi = ngram_range
    out: List[str] = []
    for n in range(lo, hi + 1):
        if n == 1:
            out.extend(tokens)
        else:
            out.extend(
                " ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
            )
    return out


class _Bucket:
    """One doc-length bucket: ELL arrays plus the row -> global-doc map."""

    __slots__ = (
        "ids", "vals", "gids", "dev_ids", "dev_vals", "dev_gids",
        "dev_ids3", "dev_vals3", "n_actual", "shards"
    )

    def __init__(self, ids: np.ndarray, vals: np.ndarray, gids: np.ndarray):
        self.ids = ids
        self.vals = vals
        self.gids = gids
        self.dev_ids = None
        self.dev_vals = None
        self.dev_gids = None
        # hashed-segment copy for the union kernel (None when the
        # union-hash gate rejects the bucket)
        self.dev_ids3 = None
        self.dev_vals3 = None
        self.n_actual = ids.shape[0]
        # mesh: per corpus shard, (device layout, host ids)
        self.shards = None


def _topk_one_layout(ids, vals, ids3, vals3, qids, qvals, kb: int,
                     use_union: bool, hash_ok: bool, two_pass: bool = False,
                     n_union=None):
    """Kernel choice for one ELL, as the JAX package makes it: union
    batches prefer the hashed-union copy when the batch's work model
    allows; per-term batches keep the layout the build gates picked.
    two_pass (the caller's gate) sends a union batch through stage 1, the
    rescore and the proof, and returns (scores, ids, per-query verdicts);
    every other choice returns (scores, ids)."""
    if use_union and two_pass:
        return sparse_topk_union_twopass(
            ids, vals, ids3 if hash_ok else None, vals3 if hash_ok else None,
            qids, qvals, kb, k_scan=_TWOPASS_K_SCAN, n_union=n_union,
            return_ok=True)
    if use_union and hash_ok and ids3 is not None:
        return sparse_topk_union_hashed(ids3, vals3, qids, qvals, kb)
    if ids.dim() == 3:  # hashed-segment primary layout
        return sparse_topk_hashed(ids, vals, qids, qvals, kb)
    if use_union:
        return sparse_topk_union(ids, vals, qids, qvals, kb)
    return sparse_topk(ids, vals, qids, qvals, kb)


def _fused_bucket_topk(buckets, qids, qvals, kbs: Tuple[int, ...], k: int,
                       use_union: bool, hash_ok: Tuple[bool, ...],
                       two_pass: Tuple[bool, ...] = (), n_union=None):
    """Every bucket's top-k, mapped to global ids and merged on the device
    by (score descending, global id ascending): the JAX package's two-key
    sort, as a stable sort by id and then a stable sort by score. Returns
    (scores, ids, ok): ok is the AND of the two-pass buckets' per-query
    verdicts, None when no bucket ran two-pass."""
    parts_s, parts_i, oks = [], [], []
    for b, kb, h_ok, tp in zip(buckets, kbs, hash_ok,
                               two_pass or (False,) * len(buckets)):
        out = _topk_one_layout(b.dev_ids, b.dev_vals, b.dev_ids3,
                               b.dev_vals3, qids, qvals, kb, use_union, h_ok,
                               tp, n_union)
        s, i = out[:2]
        if tp:
            oks.append(out[2])
        parts_s.append(s)
        parts_i.append(b.dev_gids[i.long()])
    s, i = merge_by_score_id(torch.cat(parts_s, dim=1),
                             torch.cat(parts_i, dim=1), k)
    ok = None
    for o in oks:
        ok = o if ok is None else ok & o
    return s, i.int(), ok


_BUCKET_BASE = 16

# Hashed-segment primary layout gate (TPU-measured; carried unchanged so
# a bucket gets the layout it gets in the JAX package)
_HASH_MIN_L = 64       # below this, buckets stay flat outright
_HASH_MAX_WORK = 3.0   # require Ls <= L_pad / 3
_HASH_MAX_STORE = 2.5  # require S * Ls <= 2.5 * L_pad

# Union-slot batch kernel gate (TPU-measured crossover, carried unchanged)
_UNION_MIN_SLOTS = 1024   # b*t below this, per-term kernels
_UNION_MAX_FRAC = 0.4     # unique terms <= 40% of b*t slots

# Hashed-union copy gate (TPU-measured, carried unchanged)
_UNION_HASH_MIN_N = 65_536
_UNION_HASH_MIN_L = 24
_UNION_HASH_SEGMENTS = 8
_UNION_HASH_MAX_STORE = 4.0

# Two-pass union serving gates (TPU-measured, carried unchanged): large
# buckets, small k (the stage-1 list of k_scan stays a selection), and
# nonnegative weights (the proof's bound is relative)
_TWOPASS_MIN_N = 65_536
_TWOPASS_MAX_K = 16
_TWOPASS_K_SCAN = 32

# Hashed-UB prefilter storage gate: a bucketed corpus densified into one
# (N, Lmax) gather ELL may hold at most this many times its entries
_PREFILTER_STORE_MAX = 3.0


class _Prefilter:
    """Device-resident hashed-UB prefilter state (`ops.lexical_prefilter`)."""

    __slots__ = ("n_buckets", "k_scan", "term_map", "w16", "row_norm_max",
                 "uids", "uvals")

    def __init__(self, n_buckets, k_scan, term_map, w16, row_norm_max, uids,
                 uvals):
        self.n_buckets = n_buckets
        self.k_scan = k_scan
        self.term_map = term_map          # (V,) np.int32, host
        self.w16 = w16                    # (N, H) bf16, device
        self.row_norm_max = row_norm_max  # float
        self.uids = uids                  # (N, Lmax) int32, device
        self.uvals = uvals                # (N, Lmax) f32, device


def _bucket_width(length: int) -> int:
    w = _BUCKET_BASE
    while w < length:
        w *= 2
    return w


def _fill_flat(tids: np.ndarray, vals: np.ndarray, lengths: np.ndarray,
               width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, width) ELL from per-doc entry runs (tids/vals concatenated in
    doc order, `lengths` entries each), -1/0 padded at the end."""
    n = len(lengths)
    ids = np.full((n, width), -1, np.int32)
    out = np.zeros((n, width), np.float32)
    if len(tids):
        rows = np.repeat(np.arange(n), lengths)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pos = np.arange(len(tids)) - np.repeat(starts, lengths)
        ids[rows, pos] = tids
        out[rows, pos] = vals
    return ids, out


class _EllIndex:
    """Padded-ELL storage (flat, or doc-length buckets) and device search."""

    def __init__(self, mesh=None, device: Union[str, torch.device, None] = None):
        self.mesh = check_mesh(mesh)
        self.vocab: Dict[str, int] = {}
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.doc_ids: Optional[np.ndarray] = None  # (N, L) int32, -1 pad
        self.doc_vals: Optional[np.ndarray] = None  # (N, L) float32
        self._dev_ids: Optional[torch.Tensor] = None
        self._dev_vals: Optional[torch.Tensor] = None
        self._dev_ids3: Optional[torch.Tensor] = None  # union-hash copy
        self._dev_vals3: Optional[torch.Tensor] = None
        self._buckets: Optional[List[_Bucket]] = None
        # mesh: the flat ELL's shards, (device layout, host ids) each
        self._shards = None
        self._n = 0
        self._prefilter: Optional[_Prefilter] = None
        # None = exact ELL scan; "verified" = the hashed-UB prefilter with
        # its proof and a full-scan fallback (result-exact); "fast" = its
        # candidates rescored without the fallback (exact scores, recall
        # unguarded). Opt-in, as in the JAX package.
        self.prefilter: Optional[str] = None
        self._prefilter_failed = False
        # None = auto (union kernel when the batch clears the union
        # gate); "flat" / "union" force a kernel
        self.batch_kernel: Optional[str] = None
        # "off" = the exact kernels (the default, as in the JAX package);
        # "auto" = two-pass union serving where the _TWOPASS_* gates hold
        self.two_pass: str = "off"
        self._nonneg = False  # every stored contribution >= 0 (build)
        self._twopass_demoted = False
        self._twopass_fail_streak = 0

    @property
    def ntotal(self) -> int:
        return self._n

    def _reset_build_state(self, nonneg: bool) -> None:
        """A new build drops the prefilter and the two-pass verdicts."""
        self._prefilter = None
        self._prefilter_failed = False
        self._twopass_demoted = False
        self._twopass_fail_streak = 0
        self._nonneg = nonneg

    def _set_ell(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Single flat ELL (bucketing disabled or only one bucket)."""
        self._reset_build_state(bool(vals.size == 0
                                     or float(vals.min()) >= 0.0))
        self.doc_ids, self.doc_vals = ids, vals
        self._buckets = None
        self._n = ids.shape[0]
        self._shards = None
        if self.mesh is not None:
            self._shards = self._sharded_ell(ids, vals)
            self._dev_ids = self._dev_vals = None
            self._dev_ids3 = self._dev_vals3 = None
            return
        (self._dev_ids, self._dev_vals,
         self._dev_ids3, self._dev_vals3) = self._device_ell(
            ids, vals, self.device)

    def _sharded_ell(self, ids: np.ndarray, vals: np.ndarray):
        """Mesh only: the ELL split over the corpus axis, each shard in the
        device layout `_device_ell` picks for its own rows, on its device:
        [(layout, host ids)] per shard."""
        from persian_rag_tpu_torch.parallel.sharded_lexical import shard_ell

        parts, _ = shard_ell(ids, vals, self.mesh)
        return [(self._device_ell(p_ids, p_vals, dev), p_ids)
                for (p_ids, p_vals), dev in zip(
                    parts, self.mesh.axis_devices(CORPUS_AXIS))]

    @staticmethod
    def _device_ell(ids: np.ndarray, vals: np.ndarray, device) -> Tuple[
        torch.Tensor, torch.Tensor, Optional[torch.Tensor],
        Optional[torch.Tensor],
    ]:
        """Device form of an ELL: (primary_ids, primary_vals, union_ids3,
        union_vals3). The primary is hashed-segment (N, S, Ls) when the
        repacked height clears the work and stream gates (S tried largest
        first), flat (N, L) otherwise; the union copy is the primary when
        it is 3-D, an extra hashed copy under the union-hash gates, or
        None."""

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        el = ids.shape[1]
        el_pad = ((el + 7) // 8) * 8
        if el >= _HASH_MIN_L:
            for s in (16, 8, 4):
                ids3, vals3 = hash_segments(ids, vals, s)
                ls = ids3.shape[2]
                if (
                    ls * _HASH_MAX_WORK <= el_pad
                    and s * ls <= _HASH_MAX_STORE * el_pad
                ):
                    d_ids3, d_vals3 = to_dev(ids3), to_dev(vals3)
                    return d_ids3, d_vals3, d_ids3, d_vals3
        d_ids, d_vals = to_dev(ids), to_dev(vals)
        if ids.shape[0] >= _UNION_HASH_MIN_N and el >= _UNION_HASH_MIN_L:
            s = _UNION_HASH_SEGMENTS
            ids3, vals3 = hash_segments(ids, vals, s)
            ls = ids3.shape[2]
            if s * ls <= _UNION_HASH_MAX_STORE * el_pad and 2 * ls <= el_pad:
                return d_ids, d_vals, to_dev(ids3), to_dev(vals3)
        return d_ids, d_vals, None, None

    def _set_buckets(self, buckets: List[_Bucket], n: int) -> None:
        self._reset_build_state(all(
            b.vals.size == 0 or float(b.vals.min()) >= 0.0 for b in buckets))
        self.doc_ids = None
        self.doc_vals = None
        self._dev_ids = None
        self._dev_vals = None
        self._dev_ids3 = None
        self._dev_vals3 = None
        self._buckets = buckets
        self._n = n
        self._shards = None
        for b in buckets:
            if self.mesh is not None:
                b.shards = self._sharded_ell(b.ids, b.vals)
            else:
                (b.dev_ids, b.dev_vals,
                 b.dev_ids3, b.dev_vals3) = self._device_ell(
                    b.ids, b.vals, self.device)
            b.dev_gids = torch.from_numpy(
                np.asarray(b.gids, np.int64)).to(self.device)

    def _set_ell_auto(self, ids: np.ndarray, vals: np.ndarray) -> None:
        """Bucket an already-filled (N, L) ELL (entries front-contiguous)
        by row length; a single width keeps the flat layout."""
        lengths = (ids != -1).sum(axis=1)
        row_widths = np.array(
            [_bucket_width(max(1, int(l))) for l in lengths]
        )
        widths = sorted(set(row_widths.tolist()))
        if len(widths) <= 1:
            self._set_ell(ids, vals)
            return
        buckets: List[_Bucket] = []
        for w in widths:
            sel = np.nonzero(row_widths == w)[0].astype(np.int32)
            wc = min(w, ids.shape[1])
            buckets.append(_Bucket(ids[sel, :wc], vals[sel, :wc], sel))
        self._set_buckets(buckets, ids.shape[0])

    def _build_ell(self, tids: np.ndarray, vals: np.ndarray,
                   lengths: np.ndarray) -> None:
        """Lay out per-doc entry runs as the JAX builder does: one flat
        ELL when every doc falls in one width, else one bucket per width,
        the top one clamped to the corpus-wide max length."""
        n = len(lengths)
        row_widths = np.array(
            [_bucket_width(max(1, int(l))) for l in lengths])
        widths = sorted(set(row_widths.tolist()))
        global_max = max(1, int(lengths.max(initial=0)))
        if len(widths) <= 1:
            self._set_ell(*_fill_flat(tids, vals, lengths, global_max))
            return
        entry_width = np.repeat(row_widths, lengths)
        buckets: List[_Bucket] = []
        for w in widths:
            sel = np.nonzero(row_widths == w)[0]
            take = np.nonzero(entry_width == w)[0]
            ids, vs = _fill_flat(tids[take], vals[take], lengths[sel],
                                 min(w, global_max))
            buckets.append(_Bucket(ids, vs, sel.astype(np.int32)))
        self._set_buckets(buckets, n)

    def _encode_queries(
        self, queries_terms: Sequence[List[Tuple[int, float]]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T) host arrays, T = the batch's longest query rounded up
        to 8 (a fixed cap would truncate long TF-IDF n-gram queries);
        -1 / 0 padded."""
        b = len(queries_terms)
        t_raw = max(1, max((len(q) for q in queries_terms), default=1))
        t = ((t_raw + 7) // 8) * 8
        qids = np.full((b, t), -1, np.int32)
        qvals = np.zeros((b, t), np.float32)
        for bi, terms in enumerate(queries_terms):
            for ti, (tid, v) in enumerate(terms):
                qids[bi, ti] = tid
                qvals[bi, ti] = v
        return qids, qvals

    @staticmethod
    def _hash_work_ok(uids: np.ndarray, l_pad: int, ids3) -> bool:
        """Per-batch flat-union vs hashed-union work model (host side):
        hashed pads each segment's run to 128 slots, so a small union can
        cost more than the flat kernel's 256-slot chunks over L."""
        if ids3 is None:
            return False
        s_n, ls = ids3.shape[1], ids3.shape[2]
        u = max(len(uids), 1)
        flat_slots = max(-(-u // 256) * 256, 256)
        seg_counts = np.bincount(uids % s_n, minlength=s_n)
        hashed_slots = int((-(-seg_counts // 128) * 128).sum())
        return hashed_slots * ls <= flat_slots * l_pad

    def _hash_ok_flags(self, qids_np: np.ndarray):
        """(flat_flag, per-bucket tuple) of hashed-union verdicts for
        this batch."""
        uids = np.unique(qids_np[qids_np >= 0]).astype(np.int64)

        def l_pad(ids):
            return ((ids.shape[1] + 7) // 8) * 8

        if self._buckets is None:
            flat = (
                self._hash_work_ok(
                    uids, l_pad(self.doc_ids), self._dev_ids3
                )
                if self._dev_ids3 is not None and self.doc_ids is not None
                else self._dev_ids3 is not None
            )
            return flat, ()
        return True, tuple(
            self._hash_work_ok(uids, l_pad(b.ids), b.dev_ids3)
            if b.dev_ids3 is not None
            else False
            for b in self._buckets
        )

    def _union_gate(
        self, qids_np: np.ndarray, n_unique: Optional[int] = None
    ) -> bool:
        """Per-batch kernel choice: the union kernel when the batch shares
        vocabulary (unique terms <= _UNION_MAX_FRAC of b*t slots, b*t >=
        _UNION_MIN_SLOTS), unless `batch_kernel` forces one."""
        if self.batch_kernel == "union":
            return True
        if self.batch_kernel is not None:
            return False
        b, t = qids_np.shape
        if b * t < _UNION_MIN_SLOTS:
            return False
        if n_unique is None:
            n_unique = len(np.unique(qids_np[qids_np >= 0]))
        return n_unique <= _UNION_MAX_FRAC * b * t

    # -- hashed-UB prefilter (ops.lexical_prefilter) ---------------------

    def _unified_ell_host(
        self,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Host (N, Lmax) gather ELL: the flat layout as it is, or the
        buckets densified into one matrix (None, None when a long document
        would break the storage gate)."""
        if self._buckets is None:
            return self.doc_ids, self.doc_vals
        lmax = max(b.ids.shape[1] for b in self._buckets)
        entries = sum(b.ids.size for b in self._buckets)
        if self._n * lmax > _PREFILTER_STORE_MAX * entries:
            return None, None
        ids = np.full((self._n, lmax), -1, np.int32)
        vals = np.zeros((self._n, lmax), np.float32)
        for b in self._buckets:
            w = b.ids.shape[1]
            ids[b.gids, :w] = b.ids
            vals[b.gids, :w] = b.vals
        return ids, vals

    def build_prefilter(self, n_buckets: int = 1024, k_scan: int = 256,
                        dedicated_frac: float = 0.5) -> bool:
        """Build the hashed-UB prefilter (`ops.lexical_prefilter`) on the
        index's device. Returns False, and search stays on the ELL scan,
        when the unified ELL fails the storage gate, is wider than 512
        slots (the rescore gathers (B, k_scan, Lmax) rows), or holds a
        negative contribution (the upper bound needs nonnegative ones), and
        on a mesh (the prefilter is single-device, as in the JAX package)."""
        if self._n == 0 or self.mesh is not None:
            return False
        ids, vals = self._unified_ell_host()
        if ids is None or ids.shape[1] > 512 or float(vals.min()) < 0.0:
            return False
        df = np.bincount(ids[ids >= 0].ravel(),
                         minlength=max(len(self.vocab), 1))
        term_map = assign_buckets(df, n_buckets, dedicated_frac)
        w16, row_norm_max = build_ub_image(ids, vals, term_map, n_buckets)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self._prefilter = _Prefilter(
            n_buckets, k_scan, term_map,
            to_dev(w16).bfloat16(),  # exact: w16 holds bf16 values
            row_norm_max, to_dev(ids), to_dev(vals))
        return True

    def _prefilter_search(self, qids_np: np.ndarray, qvals_np: np.ndarray,
                          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        pf = self._prefilter
        qh = hash_queries(qids_np, qvals_np, pf.term_map, pf.n_buckets)
        return prefilter_topk(
            torch.from_numpy(qh).to(self.device), pf.w16, pf.row_norm_max,
            pf.uids, pf.uvals, torch.from_numpy(qids_np).to(self.device),
            torch.from_numpy(qvals_np).to(self.device), k,
            k_scan=pf.k_scan, fallback=self.prefilter != "fast")

    # -- two-pass union serving -------------------------------------------

    TWOPASS_DEMOTE_STREAK = 3

    def _note_twopass_verdict(self, ok: Optional[np.ndarray]) -> None:
        """Sticky demotion, as the JAX package's: a dispatch where most
        queries failed the proof counts toward a streak, and
        TWOPASS_DEMOTE_STREAK such dispatches in a row turn two-pass off
        until the next build (each of them paid stage 1, the rescore and
        the exact kernel). ok=None: no two-pass bucket served the call."""
        if ok is None or ok.size == 0:
            return
        if float(ok.mean()) < 0.5:
            self._twopass_fail_streak += 1
            if (self._twopass_fail_streak >= self.TWOPASS_DEMOTE_STREAK
                    and not self._twopass_demoted):
                logger.warning(
                    "lexical two-pass proof majority-failed %d consecutive "
                    "dispatches: demoting to the exact union kernel for "
                    "this corpus", self._twopass_fail_streak)
                self._twopass_demoted = True
        else:
            self._twopass_fail_streak = 0

    def _search_device(
        self,
        queries_terms: Sequence[List[Tuple[int, float]]],
        k: int,
        allow_union: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over the whole index as device tensors ((B, k') f32,
        (B, k') int32, k' = min(k, N)). allow_union=False keeps the
        per-term kernels whatever the gate says."""
        qids_np, qvals_np = self._encode_queries(queries_terms)
        if self.prefilter in ("fast", "verified"):
            if self._prefilter is None and not self._prefilter_failed:
                self._prefilter_failed = not self.build_prefilter()
            pf = self._prefilter
            if pf is not None and k <= pf.k_scan:
                return self._prefilter_search(qids_np, qvals_np, k)
        n_unique = len(np.unique(qids_np[qids_np >= 0]))
        use_union = allow_union and self._union_gate(qids_np, n_unique)
        if self.mesh is not None:
            return self._search_mesh(qids_np, qvals_np, k, use_union)
        # the proof's relative envelope needs every contribution, stored
        # and query-side, nonnegative
        two_pass_ok = (
            use_union
            and self.two_pass == "auto"
            and not self._twopass_demoted
            and self._nonneg
            and k <= _TWOPASS_MAX_K
            and bool(qvals_np.min(initial=0.0) >= 0.0)
        )
        flat_ok, bucket_ok = (
            self._hash_ok_flags(qids_np) if use_union else (True, ())
        )
        qids = torch.from_numpy(qids_np).to(self.device)
        qvals = torch.from_numpy(qvals_np).to(self.device)
        if self._buckets is None:
            tp = two_pass_ok and self._n >= _TWOPASS_MIN_N
            out = _topk_one_layout(
                self._dev_ids, self._dev_vals, self._dev_ids3,
                self._dev_vals3, qids, qvals, k, use_union, flat_ok, tp,
                n_unique,
            )
            ok = out[2] if tp else None
        else:
            tps = tuple(two_pass_ok and b.n_actual >= _TWOPASS_MIN_N
                        for b in self._buckets)
            out = _fused_bucket_topk(
                self._buckets, qids, qvals, self.bucket_kbs(k), k, use_union,
                bucket_ok or (True,) * len(self._buckets), tps, n_unique,
            )
            ok = out[2]
        if ok is not None:
            self._note_twopass_verdict(ok.cpu().numpy())
        return out[0], out[1]

    def _search_mesh(self, qids_np: np.ndarray, qvals_np: np.ndarray, k: int,
                     use_union: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mesh search: every ELL through `sharded_sparse_topk`, the buckets
        mapped to global ids and merged by (score descending, id
        ascending). Each shard takes its own hashed-union work verdict."""
        from persian_rag_tpu_torch.parallel.sharded_lexical import (
            sharded_sparse_topk,
        )

        uids = np.unique(qids_np[qids_np >= 0]).astype(np.int64)
        qids = torch.from_numpy(qids_np).to(self.device)
        qvals = torch.from_numpy(qvals_np).to(self.device)

        def search(shards, kb, n_actual):
            hash_ok = [
                use_union and layout[2] is not None and self._hash_work_ok(
                    uids, ((host.shape[1] + 7) // 8) * 8, layout[2])
                for layout, host in shards
            ]
            return sharded_sparse_topk(
                [layout for layout, _ in shards], qids, qvals, kb, n_actual,
                self.mesh, use_union=use_union, hash_ok=hash_ok)

        if self._buckets is None:
            s, i = search(self._shards, k, self._n)
            return s, i.int()
        parts_s, parts_i = [], []
        for b, kb in zip(self._buckets, self.bucket_kbs(k)):
            s, i = search(b.shards, kb, b.n_actual)
            parts_s.append(s)
            parts_i.append(torch.where(
                i >= 0, b.dev_gids[i.clamp(min=0)], torch.full_like(i, -1)))
        s, i = merge_by_score_id(torch.cat(parts_s, dim=1),
                                 torch.cat(parts_i, dim=1), k)
        return s, i.int()

    def _search_encoded(
        self, queries_terms: Sequence[List[Tuple[int, float]]], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        s, i = self._search_device(queries_terms, k)
        return tuple(to_host(s, i))

    def bucket_kbs(self, k: int) -> Tuple[int, ...]:
        """Per-bucket top-k widths; empty for the flat layout."""
        if self._buckets is None:
            return ()
        return tuple(min(k, b.n_actual) for b in self._buckets)

    def _scores_encoded(
        self, queries_terms: Sequence[List[Tuple[int, float]]]
    ) -> np.ndarray:
        """Dense (B, N) scores from the host ELL (the device primary may
        be 3-D), computed on the index's device."""
        qids_np, qvals_np = self._encode_queries(queries_terms)
        qids = torch.from_numpy(qids_np).to(self.device)
        qvals = torch.from_numpy(qvals_np).to(self.device)

        def scores(ids, vals):
            return sparse_scores_ref(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(vals).to(self.device), qids, qvals,
            ).cpu().numpy()

        if self._buckets is None:
            return scores(self.doc_ids, self.doc_vals)
        out = np.zeros((len(queries_terms), self.ntotal), np.float32)
        for b in self._buckets:
            out[:, b.gids] = scores(b.ids, b.vals)
        return out

    def _save_arrays(self, path: str, extra: Dict) -> None:
        """npz arrays + a .meta.json, in the JAX package's format."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        if self._buckets is None:
            arrays["doc_ids"] = self.doc_ids
            arrays["doc_vals"] = self.doc_vals
        else:
            for bi, b in enumerate(self._buckets):
                arrays[f"bucket_ids_{bi}"] = b.ids
                arrays[f"bucket_vals_{bi}"] = b.vals
                arrays[f"bucket_gids_{bi}"] = b.gids
        np.savez(
            path if path.endswith(".npz") else path + ".npz", **arrays
        )
        meta = dict(extra)
        meta["vocab"] = self.vocab
        if self._buckets is not None:
            meta["n_buckets"] = len(self._buckets)
            meta["ntotal"] = self._n
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False)

    def _load_arrays(self, path: str) -> Dict:
        npz = path if path.endswith(".npz") else path + ".npz"
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".meta.json", "r", encoding="utf-8") as f:
            meta = json.load(f)
        with np.load(npz) as data:
            if "n_buckets" in meta:
                buckets = [
                    _Bucket(
                        data[f"bucket_ids_{bi}"],
                        data[f"bucket_vals_{bi}"],
                        data[f"bucket_gids_{bi}"],
                    )
                    for bi in range(meta.pop("n_buckets"))
                ]
                self._set_buckets(buckets, meta.pop("ntotal"))
            else:
                self._set_ell(data["doc_ids"], data["doc_vals"])
        self.vocab = meta.pop("vocab")
        return meta


def bm25_idf(terms: Sequence[str], doc_freq: Sequence[int], n: int,
             epsilon: float) -> Dict[str, float]:
    """rank_bm25's idf, ln((N - df + 0.5) / (df + 0.5)) with negative
    values replaced by epsilon * the mean raw idf: the JAX package's scalar
    loop (np.log of a scalar), in vocabulary order. Both builders take it,
    so their idf agree bit for bit."""
    raw_idf = {}
    idf_sum = 0.0
    negative = []
    for term, freq in zip(terms, doc_freq):
        idf = np.log(n - freq + 0.5) - np.log(freq + 0.5)
        raw_idf[term] = idf
        idf_sum += idf
        if idf < 0:
            negative.append(term)
    average_idf = idf_sum / max(len(raw_idf), 1)
    eps = epsilon * average_idf
    for term in negative:
        raw_idf[term] = eps
    return raw_idf


def _entry_runs(doc_counters, vocab):
    """Concatenated (term id, count) entries of every doc in Counter
    order, keeping only in-vocabulary terms, and each doc's entry count."""
    tids: List[int] = []
    tfs: List[int] = []
    lengths = np.zeros(len(doc_counters), np.int64)
    for di, counter in enumerate(doc_counters):
        before = len(tids)
        for term, tf in counter.items():
            tid = vocab.get(term)
            if tid is not None:
                tids.append(tid)
                tfs.append(tf)
        lengths[di] = len(tids) - before
    return (np.asarray(tids, np.int64), np.asarray(tfs, np.float64),
            lengths)


class BM25Index(_EllIndex):
    """Okapi BM25 with rank_bm25-identical scores."""

    def __init__(
        self,
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(mesh=mesh, device=device)
        self.k1 = k1
        self.b = b
        self.epsilon = epsilon

    def build(
        self, texts: Sequence[str], use_native: Optional[bool] = None
    ) -> "BM25Index":
        """Build the index. use_native=None takes the C++ builder
        (`native/lexical_native.cpp`: tokenize, vocabulary, counts and the
        contributions) where it builds, and logs the compiler's error and
        takes the Python builder where it does not; True raises when it
        does not build; False takes the Python builder. Both give the same
        arrays, vocabulary, idf and avgdl bit for bit."""
        if use_native is not False:
            from persian_rag_tpu_torch import native

            if use_native or native.available():
                # re-joined on single spaces, so that the C++ ASCII
                # whitespace split sees exactly str.split()'s tokens
                joined = [" ".join(whitespace_tokenize(t)) for t in texts]
                if not joined:
                    raise ValueError("empty corpus")
                ids, vals, vocab, idf, avgdl = native.bm25_build_ell(
                    joined, self.k1, self.b, self.epsilon)
                self.vocab = vocab
                self.idf = idf
                self._avgdl = avgdl
                self._set_ell_auto(ids, vals)
                return self
        return self._build_python(texts)

    def _build_python(self, texts: Sequence[str]) -> "BM25Index":
        tokenized = [whitespace_tokenize(t) for t in texts]
        n = len(tokenized)
        if n == 0:
            raise ValueError("empty corpus")
        doc_lens = np.array([len(t) for t in tokenized], np.float64)
        avgdl = doc_lens.mean() if n else 0.0

        doc_counters = [Counter(tokens) for tokens in tokenized]
        df: Counter = Counter()
        for c in doc_counters:
            df.update(c.keys())
        self.vocab = {term: i for i, term in enumerate(df.keys())}

        raw_idf = bm25_idf(list(df.keys()), list(df.values()), n,
                           self.epsilon)
        self.idf = raw_idf

        # contrib = idf * tf * (k1 + 1) / (tf + k1 (1 - b + b dl / avgdl)),
        # the same float64 operations in the same order as the loop
        tids, tfs, lengths = _entry_runs(doc_counters, self.vocab)
        idf_arr = np.array([raw_idf[t] for t in self.vocab], np.float64)
        denom_norm = self.k1 * (
            1.0 - self.b + self.b * doc_lens / max(avgdl, 1e-12))
        contrib = idf_arr[tids] * tfs * (self.k1 + 1.0) / (
            tfs + np.repeat(denom_norm, lengths))
        self._build_ell(tids, contrib.astype(np.float32), lengths)
        self._avgdl = float(avgdl)
        return self

    def _query_terms(self, query: str) -> List[Tuple[int, float]]:
        counts = Counter(whitespace_tokenize(query))
        # out-of-vocabulary query terms contribute 0 (rank_bm25 behavior)
        return [
            (self.vocab[t], float(m)) for t, m in counts.items() if t in self.vocab
        ]

    def get_scores(self, query: str) -> np.ndarray:
        """(N,) BM25 scores, equal to rank_bm25.BM25Okapi.get_scores."""
        return self._scores_encoded([self._query_terms(query)])[0]

    def search(
        self, queries: Sequence[str], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        terms = [self._query_terms(q) for q in queries]
        return self._search_encoded(terms, min(k, self.ntotal))

    def save(self, path: str) -> None:
        self._save_arrays(
            path,
            {
                "type": "bm25",
                "k1": self.k1,
                "b": self.b,
                "epsilon": self.epsilon,
                "avgdl": self._avgdl,
                "idf": self.idf,
            },
        )

    @classmethod
    def load(cls, path: str,
             device: Union[str, torch.device, None] = None) -> "BM25Index":
        index = cls(device=device)
        meta = index._load_arrays(path)
        index.k1 = meta["k1"]
        index.b = meta["b"]
        index.epsilon = meta["epsilon"]
        index._avgdl = meta["avgdl"]
        index.idf = meta["idf"]
        return index


class TfidfIndex(_EllIndex):
    """TF-IDF retrieval with sklearn-identical weighting and cosine scores."""

    def __init__(
        self,
        max_features: Optional[int] = 10000,
        ngram_range: Tuple[int, int] = (1, 2),
        mesh=None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(mesh=mesh, device=device)
        self.max_features = max_features
        self.ngram_range = tuple(ngram_range)

    def build(self, texts: Sequence[str]) -> "TfidfIndex":
        analyzed = [sklearn_analyzer(t, self.ngram_range) for t in texts]
        n = len(analyzed)
        if n == 0:
            raise ValueError("empty corpus")
        doc_counters = [Counter(terms) for terms in analyzed]

        term_freq: Counter = Counter()
        df: Counter = Counter()
        for c in doc_counters:
            term_freq.update(c)
            df.update(c.keys())

        terms = sorted(df.keys())
        if self.max_features is not None and len(terms) > self.max_features:
            # sklearn _limit_features: the max_features terms of highest
            # total count, by the same (unstable) argsort over the
            # alphabetical vocabulary, so ties resolve identically
            tfs = np.array([term_freq[t] for t in terms], dtype=np.int64)
            keep = np.argsort(-tfs)[: self.max_features]
            terms = sorted(terms[i] for i in keep)
        self.vocab = {t: i for i, t in enumerate(terms)}

        idf = np.zeros(len(terms), np.float64)
        for t, i in self.vocab.items():
            idf[i] = np.log((1.0 + n) / (1.0 + df[t])) + 1.0
        self._idf = idf

        tids, tfs_doc, lengths = _entry_runs(doc_counters, self.vocab)
        w = tfs_doc * idf[tids]
        # l2 row norms summed left to right per doc, as Python's sum()
        sq = w * w
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        acc = np.zeros(n, np.float64)
        for j in range(int(lengths.max(initial=0))):
            rows = np.nonzero(lengths > j)[0]
            acc[rows] = acc[rows] + sq[starts[rows] + j]
        norm = np.repeat(np.sqrt(acc), lengths)
        w = np.where(norm > 0, w / np.where(norm > 0, norm, 1.0), w)
        self._build_ell(tids, w.astype(np.float32), lengths)
        return self

    def _query_terms(self, query: str) -> List[Tuple[int, float]]:
        counts = Counter(sklearn_analyzer(query, self.ngram_range))
        entries = [
            (self.vocab[t], tf * self._idf[self.vocab[t]])
            for t, tf in counts.items()
            if t in self.vocab
        ]
        norm = np.sqrt(sum(v * v for _, v in entries))
        if norm > 0:
            entries = [(tid, float(v / norm)) for tid, v in entries]
        return entries

    def get_scores(self, query: str) -> np.ndarray:
        """(N,) cosine similarities, equal to sklearn cosine_similarity
        over TfidfVectorizer rows."""
        return self._scores_encoded([self._query_terms(query)])[0]

    def search(
        self, queries: Sequence[str], k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        terms = [self._query_terms(q) for q in queries]
        return self._search_encoded(terms, min(k, self.ntotal))

    def save(self, path: str) -> None:
        self._save_arrays(
            path,
            {
                "type": "tfidf",
                "max_features": self.max_features,
                "ngram_range": list(self.ngram_range),
                "idf": self._idf.tolist(),
            },
        )

    @classmethod
    def load(cls, path: str,
             device: Union[str, torch.device, None] = None) -> "TfidfIndex":
        index = cls(device=device)
        meta = index._load_arrays(path)
        index.max_features = meta["max_features"]
        index.ngram_range = tuple(meta["ngram_range"])
        index._idf = np.asarray(meta["idf"])
        return index
