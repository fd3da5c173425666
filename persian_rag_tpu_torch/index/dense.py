"""Device-resident dense flat index: f32, bf16 and int8 storage tiers.

The counterpart of ``persian_rag_tpu.index.dense.DenseIndex`` on one
device. Semantics kept for FAISS parity:

* metric "l2" returns squared L2 distances ascending (IndexFlatL2);
  "ip" inner products descending (IndexFlatIP); "cosine" L2-normalizes the
  rows once at commit and the queries per search, then ranks by dot;
* ties prefer the lower row id; ids are insertion order.

Storage tiers (``storage_dtype``):

* float32: exact. `commit()` builds the two-stage serving caches on the
  device (row sqnorms, the mean-centered bf16 stage-1 image, its max
  centered norm and, for the bf16x2 stage 1, the bf16 lo residues), and a
  margin probe picks the cheapest stage 1 whose proof bound clears the
  corpus's score gaps.
* bfloat16: half the bytes, approximate. ip/cosine rows are stored
  mean-centered (rows of real embeddings share a dominant mean direction,
  and the discriminative part of a raw dot is below bf16's mantissa step);
  l2 rows uncentered. Searches are exact over the STORED rows and add
  <q, mu> back to the scores.
* int8 (ip/cosine only): mean-centered rows, per-row absmax scales. A
  candidate-generation tier: `search(refine_k=...)` over-retrieves on the
  int8 rows and re-ranks the candidates exactly against a `refine_dtype`
  copy (refine_dtype=None stores the int8 tier alone and serves its raw
  scores plus <q, mu>).

`quality_floor` gates the approximate tiers (bf16; int8 without a refine
copy): `commit()` estimates Recall@10 of the would-be storage against the
exact f32 ranking on the host (held-out rows as queries) and, below the
floor, demotes per `quality_fallback`: "exact" (f32 storage),
"int8_refine", or "keep" (warn only). The verdict is `tier_probe`.

Index files: `save` / `load` (.npz + .meta.json) and `export_faiss` /
`from_faiss` (flat FAISS files), both in the JAX package's formats.

Searches return tensors on the index's device. With a `mesh`
(``core.mesh``) the committed rows and their serving caches also shard
over the mesh's corpus axis (padded to a shard multiple), and a search
goes through ``parallel.sharded_search``: int8 storage through
`sharded_int8_topk` (a refine copy is required, as in the JAX package), a
data axis > 1 with at least as many queries through the 2-D route, else
`sharded_flat_topk`. The index's device is then the mesh's first device,
where the merged results land; the unsharded tensors stay there too
(`rows`, `vectors`, `save` and the hybrid chain read them).
"""
from __future__ import annotations

import json
import logging
import os
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device
from persian_rag_tpu_torch.core.mesh import (
    CORPUS_AXIS,
    DATA_AXIS,
    check_mesh,
    pad_to_multiple,
)
from persian_rag_tpu_torch.index import faiss_io
from persian_rag_tpu_torch.ops.hybrid_fusion import gather_rows_device
from persian_rag_tpu_torch.ops.flat_topk import (
    NEG_INF,
    SCALED_N_EASY,
    SCALED_TILE_N,
    SEARCH_MODES,
    TWO_STAGE_MIN_N,
    _bf16_matmul_eps,
    _bf16x2_matmul_eps,
    _topk_desc,
    as_dtype,
    flat_topk,
    flat_topk_scaled_candidates,
    full_f32,
)

_METRICS = ("l2", "ip", "cosine")

logger = logging.getLogger(__name__)


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """Host image of bf16 storage (round to nearest even, the rounding the
    device conversion applies)."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()


def _host_topk_ids(
    q: np.ndarray, mat: np.ndarray, metric: str, k: int, block: int = 131072
) -> np.ndarray:
    """(qn, k) top-k ids over `mat` rows (score desc, lower id on ties),
    blocked over N so the probe never materializes a (qn, N) score matrix
    at large N. metric "l2" ranks by the serving path's maximize-space
    2 q.c - ||c||^2 with sqnorms from `mat` itself (bf16 l2 serving derives
    its sqnorm cache from the STORED values, so the probe must too)."""
    n = mat.shape[0]
    k = min(k, n)
    cand_s = []
    cand_i = []
    for start in range(0, n, block):
        m = mat[start : start + block]
        s = q @ m.T
        if metric == "l2":
            s = 2.0 * s - np.einsum("nd,nd->n", m, m)[None, :]
        kk = min(k, s.shape[1])
        part = np.argpartition(-s, kth=kk - 1, axis=1)[:, :kk]
        cand_i.append(part + start)
        cand_s.append(np.take_along_axis(s, part, axis=1))
    cs = np.concatenate(cand_s, axis=1)
    ci = np.concatenate(cand_i, axis=1)
    out = np.empty((q.shape[0], k), np.int64)
    for qi in range(q.shape[0]):
        order = np.lexsort((ci[qi], -cs[qi]))[:k]
        out[qi] = ci[qi][order]
    return out


def _quantize_int8(corpus: np.ndarray):
    """Mean-centered per-row absmax int8 quantization on the host:
    (center (d,), scales (N,), values (N, d) int8)."""
    center = corpus.mean(axis=0).astype(np.float32)
    centered = corpus - center[None, :]
    absmax = np.abs(centered).max(axis=1)
    scales = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
    values = np.clip(np.rint(centered / scales[:, None]), -127, 127)
    return center, scales, values.astype(np.int8)


def _refine_topk(queries, refine_corpus, cand_ids, k):
    """Exact re-scoring of candidates against the full-precision rows:
    gather (Q, R, d) rows, one f32 product, top-k. cand_ids: (Q, R), -1 =
    pad; the candidate order is the tie order (stable sort)."""
    rows = refine_corpus[torch.clamp(cand_ids, min=0)].float()
    with full_f32():
        scores = torch.einsum("qd,qrd->qr", queries.float(), rows)
    scores = torch.where(
        cand_ids >= 0, scores, torch.full_like(scores, NEG_INF))
    top_s, pos = _topk_desc(scores, k)
    return top_s, torch.gather(cand_ids, 1, pos)


class FusedArgs(NamedTuple):
    """The committed corpus and its serving caches, as device tensors."""

    corpus: torch.Tensor  # (N, d) stored rows: f32, bf16 or int8
    corpus_sqnorm: Optional[torch.Tensor]  # (N,) f32 sqnorms of stored rows
    corpus_bf16: Optional[torch.Tensor]  # (N, d) centered stage-1 image (f32)
    corpus_center: Optional[torch.Tensor]  # (d,) mean the image is centered on
    center_sqmax: Optional[torch.Tensor]  # () f32 max centered row sqnorm
    corpus_bf16_lo: Optional[torch.Tensor]  # (N, d) bf16 lo residues (bf16x2)
    corpus_scale: Optional[torch.Tensor]  # (N,) f32 int8 row scales
    refine_corpus: Optional[torch.Tensor]  # (N, d) int8 tier's exact rows
    center: Optional[torch.Tensor]  # (d,) mean the STORED rows are centered on


class DenseIndex:
    """Flat exact-search index over an (N, d) embedding matrix."""

    DEMOTE_STREAK = 3  # consecutive majority-fail dispatches before demotion

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        device: Union[str, torch.device, None] = None,
        storage_dtype=torch.float32,
        mesh=None,
        compute_dtype=torch.float32,
        search_mode: str = "exact",
        refine_dtype: Optional[str] = "float32",
        quality_floor: Optional[float] = 0.95,
        quality_fallback: str = "exact",
    ):
        """device: None is the card (raises without CUDA); "cpu" asks for
        the CPU. mesh: a `core.mesh.Mesh` to shard the rows over (its first
        device is then the index's). storage_dtype: float32, bfloat16 or
        int8 (a torch dtype or its name). search_mode "fast" ranks by
        scores truncated to 21 bits where the running top-k serves the
        call; "fasti" and "fastg" return the same lists through kernels of
        their own. Any mode outside SEARCH_MODES raises (maxonly, a floor
        with no ids, is no search mode). The defaults are bit-exact
        FAISS-parity behavior; see the module docstring for the tiers and
        the quality gate."""
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {metric}")
        storage_dtype = as_dtype(storage_dtype)
        if storage_dtype == torch.int8 and metric == "l2":
            raise ValueError("int8 storage supports ip/cosine only")
        if quality_fallback not in ("exact", "int8_refine", "keep"):
            raise ValueError("quality_fallback must be exact|int8_refine|keep")
        if search_mode not in SEARCH_MODES:
            raise ValueError(
                f"search_mode must be one of {SEARCH_MODES}, got {search_mode!r}")
        self.mesh = check_mesh(mesh)
        if mesh is not None and storage_dtype == torch.int8 \
                and refine_dtype is None:
            raise ValueError(
                "int8 storage on a mesh requires a refine copy (the sharded "
                "tier re-scores per-shard candidates exactly; raw int8-score "
                "serving is single-device)")
        self.dim = dim
        self.metric = metric
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.storage_dtype = storage_dtype
        self.compute_dtype = as_dtype(compute_dtype)
        self.search_mode = search_mode
        self.refine_dtype = refine_dtype
        self.quality_floor = quality_floor
        self.quality_fallback = quality_fallback
        # the tier the caller asked for: each commit re-probes it against
        # the (possibly grown) corpus rather than inheriting a demotion
        self._requested_storage = storage_dtype
        self._requested_refine = refine_dtype
        # commit-time tier-quality probe verdict (None until an approximate
        # tier is committed with quality_floor set): {"tier",
        # "estimated_recall", "floor", "demoted_to"}
        self.tier_probe: Optional[dict] = None
        self._pending: List[np.ndarray] = []
        self._device_corpus: Optional[torch.Tensor] = None
        self._row_scales: Optional[torch.Tensor] = None  # int8: (N,) f32
        self._center: Optional[torch.Tensor] = None  # centered storage: (d,)
        self._refine_corpus: Optional[torch.Tensor] = None
        self._ntotal = 0
        # two-stage serving caches, derived from the stored rows at commit
        self._sqnorms: Optional[torch.Tensor] = None
        self._stage1_bf16: Optional[torch.Tensor] = None
        self._stage1_center: Optional[torch.Tensor] = None
        self._center_sqmax: Optional[torch.Tensor] = None
        self._stage1_lo: Optional[torch.Tensor] = None
        # commit-time margin probe outcome: "bf16", "bf16x2" or "scan"
        self._stage1_mode: str = "bf16"
        self._fail_streak = 0
        # mesh: the padded, row-sharded copies of the tensors above
        self._shards: Optional[dict] = None

    # -- construction -------------------------------------------------------

    @property
    def ntotal(self) -> int:
        return self._ntotal + sum(v.shape[0] for v in self._pending)

    @property
    def d(self) -> int:  # FAISS-compatible alias
        return self.dim

    def add(self, vectors: np.ndarray) -> None:
        """Stage vectors host-side; `commit()` moves them to the device."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}), got {vectors.shape}")
        self._pending.append(vectors)

    def commit(self) -> None:
        """Materialize the index and its serving caches on the device."""
        if not self._pending and self._device_corpus is not None:
            return
        parts = []
        if self._device_corpus is not None:
            # dequantized storage (the refine copy where one is kept)
            parts.append(self._dequantized()[: self._ntotal])
        parts.extend(self._pending)
        if not parts:
            raise ValueError("index is empty")
        corpus = np.concatenate(parts, axis=0)
        if self.metric == "cosine":
            corpus = _l2_normalize(corpus)
        self._pending.clear()
        self._ntotal = corpus.shape[0]
        self._sqnorms = None
        self._stage1_bf16 = None
        self._stage1_center = None
        self._center_sqmax = None
        self._stage1_mode = "bf16"
        self._stage1_lo = None
        self._fail_streak = 0
        self._center = None
        self._row_scales = None
        self._refine_corpus = None
        self.tier_probe = None
        if self.quality_floor is not None:
            self.storage_dtype = self._requested_storage
            self.refine_dtype = self._requested_refine
            self._apply_quality_gate(corpus)

        def to_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if self.storage_dtype == torch.int8:
            # quantize mean-CENTERED rows: centering is ranking-invariant
            # (<q, c - mu> = <q, c> - <q, mu>, constant per query); the
            # refine step restores exact scores, unrefined searches add
            # <q, mu> back
            center, scales, values = _quantize_int8(corpus)
            self._center = to_device(center)
            self._row_scales = to_device(scales)
            self._device_corpus = to_device(values)
            if self.refine_dtype is not None:
                self._refine_corpus = to_device(corpus).to(
                    as_dtype(self.refine_dtype))
            self._shard_state()
            return
        store_src = corpus
        if self.storage_dtype == torch.bfloat16 and self.metric != "l2":
            # bf16 ip/cosine rows are stored mean-centered like the int8
            # tier; l2 keeps uncentered storage (its ranking information
            # rides the f32 ||c||^2 cache)
            center = corpus.mean(axis=0).astype(np.float32)
            store_src = corpus - center[None, :]
            self._center = to_device(center)
        arr = to_device(store_src).to(self.storage_dtype)
        self._device_corpus = arr
        # sqnorms of the STORED values, the expression the search path
        # would otherwise evaluate per call
        a32 = arr.float()
        self._sqnorms = torch.sum(a32 * a32, dim=-1)
        if arr.dtype == torch.bfloat16:
            # a bf16 corpus is its own stage-1 image: no centered image,
            # no margin probe
            self._shard_state()
            return
        # stage-1 image is MEAN-CENTERED: on real embedding geometry (rows
        # in a tight cone) the uncentered bf16 proof fails on every batch;
        # centering is ranking-invariant and the two-stage path translates
        # its bound by <q, mu>
        mu = torch.mean(a32, dim=0)
        centered = a32 - mu[None, :]
        self._stage1_center = mu
        self._center_sqmax = torch.max(torch.sum(centered * centered, dim=-1))
        self._stage1_bf16 = centered.bfloat16()
        self._set_stage1_mode(self._probe_stage1_mode(a32, centered))

    def _shard_state(self) -> None:
        """Mesh only: pad the committed tensors to a shard multiple and
        place them row-sharded (`parallel.sharded_search.shard_rows`). Pad
        rows are zero rows of the stored corpus, and every cache pads with
        what a zero row gives it (sqnorm 0, stage-1 image -mu and its lo
        residue), so each shard's two-stage proof sees one consistent
        corpus; int8 scales and refine rows pad with zeros."""
        self._shards = None
        if self.mesh is None or self._device_corpus is None:
            return
        from persian_rag_tpu_torch.parallel.sharded_search import shard_rows

        n_shards = self.mesh.shape[CORPUS_AXIS]
        pad = pad_to_multiple(max(self._ntotal, n_shards), n_shards) \
            - self._ntotal

        def shard(t, pad_row=None):
            if t is None:
                return None
            if pad_row is not None:
                t = torch.cat([t, pad_row.expand(pad, -1)])
            return shard_rows(t, self.mesh)[0]

        out = {"corpus": shard(self._device_corpus),
               "sqnorm": shard(self._sqnorms),
               "scale": shard(self._row_scales),
               "refine": shard(self._refine_corpus),
               "bf16": None, "lo": None, "center_sqmax": self._center_sqmax}
        if self._stage1_bf16 is not None:
            zero = -self._stage1_center[None, :]  # a zero row, centered
            hi = zero.bfloat16()
            out["bf16"] = shard(self._stage1_bf16, hi)
            out["lo"] = shard(self._stage1_lo, (zero - hi.float()).bfloat16())
            if pad:
                out["center_sqmax"] = torch.maximum(
                    self._center_sqmax, torch.sum(zero * zero))
        self._shards = out

    def _dequantized(self) -> np.ndarray:
        """Host f32 copy of the committed rows: the refine copy where one
        is kept, else the stored values times their scales plus the
        center."""
        if self._refine_corpus is not None:
            return self._refine_corpus.float().cpu().numpy()
        out = self._device_corpus.float().cpu().numpy()
        if self._row_scales is not None:
            out = out * self._row_scales.cpu().numpy()[:, None]
        if self._center is not None:
            out = out + self._center.cpu().numpy()[None, :]
        return out

    def _apply_quality_gate(self, corpus: np.ndarray) -> None:
        """Commit-time recall probe over the APPROXIMATE storage tiers
        (bf16; int8 without a refine copy). Held-out corpus rows query a
        host-quantized image of the would-be storage; if the estimated
        Recall@10 against the exact f32 ranking falls below quality_floor,
        the tier is demoted per quality_fallback before anything is
        materialized on the device."""
        approx_tier = self.storage_dtype == torch.bfloat16 or (
            self.storage_dtype == torch.int8 and self.refine_dtype is None
        )
        n = corpus.shape[0]
        if not approx_tier or n < 128:
            return
        est = self._estimate_tier_recall(corpus)
        tier = "bfloat16" if self.storage_dtype == torch.bfloat16 else "int8"
        self.tier_probe = {
            "tier": tier,
            "estimated_recall": est,
            "floor": self.quality_floor,
            "demoted_to": None,
        }
        if est >= self.quality_floor:
            return
        if self.quality_fallback == "keep":
            logger.warning(
                "%s storage tier probe estimates Recall@10=%.4f < floor "
                "%.2f on this corpus geometry (quality_fallback='keep': "
                "serving the approximate tier anyway)",
                tier, est, self.quality_floor,
            )
            return
        if self.quality_fallback == "int8_refine" and self.metric != "l2":
            self.storage_dtype = torch.int8
            self.refine_dtype = self.refine_dtype or "float32"
            demoted = "int8_refine"
        else:
            self.storage_dtype = torch.float32
            demoted = "exact"
        self.tier_probe["demoted_to"] = demoted
        logger.warning(
            "%s storage tier probe estimates Recall@10=%.4f < floor %.2f "
            "on this corpus geometry: demoting to %s (set "
            "quality_floor=None to keep the tier unconditionally)",
            tier, est, self.quality_floor, demoted,
        )

    def _estimate_tier_recall(
        self, corpus: np.ndarray, qn: int = 64, k: int = 10
    ) -> float:
        """Sampled self-recall of the approximate tier against the exact
        f32 ranking, both computed on the host in f32 (this isolates the
        QUANTIZATION loss). The sample is seeded by the corpus shape, as in
        the JAX package, so both packages record the same verdict."""
        n, d = corpus.shape
        rng = np.random.default_rng(n ^ (d << 20))
        idx = rng.choice(n, size=min(qn, n), replace=False)
        q = np.ascontiguousarray(corpus[idx], dtype=np.float32)
        # the centered tiers serve <q, c - mu> with the ORIGINAL query (the
        # shift is constant per query); the probe scores the same way
        if self.storage_dtype == torch.bfloat16:
            if self.metric != "l2":
                mu = corpus.mean(axis=0, dtype=np.float64).astype(np.float32)
                store = _round_bf16(corpus - mu[None, :])
            else:
                store = _round_bf16(corpus)
        else:  # raw int8 (mirrors the centered per-row-absmax commit)
            _, scales, values = _quantize_int8(corpus)
            store = (values.astype(np.float64) * scales[:, None]).astype(
                np.float32)
        want = _host_topk_ids(q, corpus, self.metric, k)
        got = _host_topk_ids(q, store, self.metric, k)
        hits = sum(
            len(set(got[i]) & set(want[i])) for i in range(want.shape[0])
        )
        return hits / float(want.size)

    def _set_stage1_mode(self, mode: str) -> None:
        """Serve stage 1 as `mode` ("bf16", "bf16x2" or "scan"), building
        the bf16 lo residues of the centered corpus only for bf16x2. The
        commit probe, the runtime demotion and scripts that force a mode
        all set it here."""
        if mode not in ("bf16", "bf16x2", "scan"):
            raise ValueError(f"unknown stage-1 mode {mode!r}")
        self._stage1_mode = mode
        self._stage1_lo = None
        if mode == "bf16x2":
            centered = self._device_corpus - self._stage1_center[None, :]
            self._stage1_lo = (centered - self._stage1_bf16.float()).bfloat16()
        if self.mesh is not None:
            self._shard_state()

    def _probe_stage1_mode(self, a32: torch.Tensor, centered: torch.Tensor) -> str:
        """Commit-time margin probe: 64 synthetic queries (perturbed corpus
        rows, drawn from a torch.Generator seeded with N) against the
        centered corpus pick the cheapest stage 1 whose proof bound clears
        the observed 10th-to-33rd score gaps with 2x slack. A wrong pick
        costs speed only: the per-dispatch proof still guards exactness."""
        n, d = a32.shape
        if n < TWO_STAGE_MIN_N:
            return "bf16"  # two-stage regime not engaged below this
        pn = 64
        gen = torch.Generator().manual_seed(n)
        idx = torch.randint(0, n, (pn,), generator=gen)
        noise = torch.randn((pn, d), generator=gen, dtype=torch.float32)
        std = torch.std(a32, correction=0)
        probe = a32[idx.to(a32.device)] + 0.05 * std * noise.to(a32.device)
        # the ~1e-5 gaps this probe resolves need full f32, not TF32
        with full_f32():
            s = probe @ centered.T
        if self.metric == "l2":
            # gaps in the l2 maximize space 2 q.c - ||c||^2 (invariant to
            # the centering shift per query)
            s = 2.0 * s - self._sqnorms[None, :]
        top = torch.topk(s, 33, dim=1).values
        err_f = 2.0 if self.metric == "l2" else 1.0
        cn = torch.sqrt(self._center_sqmax)
        qn = torch.linalg.norm(probe, dim=1)
        gap = top[:, 9] - top[:, 32]
        stats = torch.stack([
            (gap > 2.0 * err_f * _bf16_matmul_eps(d) * qn * cn).all(),
            (gap > 2.0 * err_f * _bf16x2_matmul_eps(d) * qn * cn).all(),
        ]).cpu()
        if bool(stats[0]):
            return "bf16"
        if bool(stats[1]):
            return "bf16x2"
        return "scan"

    def _note_proof_verdict(self, ok: Optional[torch.Tensor]) -> None:
        """Runtime stage-1 demotion from the live proof-verdict stream: a
        dispatch where the MAJORITY of queries failed the proof counts
        toward a streak; DEMOTE_STREAK consecutive ones flip the stage-1
        mode to "scan" (sticky until the next commit). ok is None when a
        non-two-stage regime served the call: no evidence either way."""
        if ok is None or ok.numel() == 0:
            return
        if float(ok.float().mean()) < 0.5:
            self._fail_streak += 1
            if (
                self._fail_streak >= self.DEMOTE_STREAK
                and self._stage1_mode != "scan"
            ):
                logger.warning(
                    "two-stage residual proof majority-failed %d "
                    "consecutive dispatches (stage1=%s): demoting exact "
                    "serving to the chunked f32 scan for this corpus",
                    self._fail_streak,
                    self._stage1_mode,
                )
                self._set_stage1_mode("scan")
        else:
            self._fail_streak = 0

    # -- search -------------------------------------------------------------

    def search(
        self, queries, k: int, refine_k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch search of host or device queries.

        Returns (scores, ids) tensors on the index's device, each (Q, k),
        or (k,) for one 1-D query:
        * l2      -> squared distances, ascending (FAISS IndexFlatL2)
        * ip      -> inner products, descending  (FAISS IndexFlatIP)
        * cosine  -> cosine similarities, descending

        refine_k (int8 storage with a refine copy only): over-retrieve
        refine_k candidates on the int8 rows, then re-score them exactly
        against the refine-dtype rows. Defaults to max(10*k, 100); pass
        refine_k=0 to force the raw int8 scores.
        """
        if isinstance(queries, torch.Tensor):
            q = queries.float()
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32))
        squeeze = q.dim() == 1
        if squeeze:
            q = q[None, :]
        scores, ids = self.search_device(q.to(self.device), k, refine_k)
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    def _int8_candidates_ok(
        self, refine: bool, metric: str, k_scan: int
    ) -> bool:
        """Whether the int8 tier's stage 1 can use merge-free candidate
        selection: refine must re-rank (it repairs selection's per-tile
        cap), and the candidate POOL must dominate the over-retrieve:
        `flat_topk_scaled_candidates` extracts 7 keys per 2048-row tile, so
        require ceil(n/2048)*7 >= 2*k_scan (at k_scan=100, n >= ~58.5k).
        Smaller corpora keep the running top-k, whose per-tile depth is
        k_scan itself. The same route on CUDA and CPU tensors."""
        pool = -(-self._ntotal // SCALED_TILE_N) * SCALED_N_EASY
        return refine and metric == "dot" and pool >= 2 * k_scan

    def search_device(
        self, queries: torch.Tensor, k: int, refine_k: Optional[int] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, d) device queries -> (scores, ids) device tensors; the only
        host read is the two-stage proof verdict, which also feeds the
        runtime demotion."""
        if self._pending:
            self.commit()
        if self._device_corpus is None:
            raise ValueError("index is empty; add() + commit() first")
        queries = queries.float()
        if self.metric == "cosine":
            norms = torch.linalg.norm(queries, dim=1, keepdim=True)
            queries = queries / torch.clamp(norms, min=1e-12)
        metric = "l2" if self.metric == "l2" else "dot"
        k = min(k, self._ntotal)
        if self.mesh is not None:
            return self._search_mesh(queries, k, refine_k, metric)
        args = self.fused_args()
        int8 = self.storage_dtype == torch.int8
        refine = int8 and args.refine_corpus is not None and refine_k != 0
        # int8 values are exact in bf16: a bf16 contraction loses nothing
        # on the quantized rows
        compute = torch.bfloat16 if int8 else self.compute_dtype
        k_scan = k
        if refine:
            k_scan = min(max(refine_k or max(10 * k, 100), k), self._ntotal)
        if self._int8_candidates_ok(refine, metric, k_scan):
            cand = flat_topk_scaled_candidates(
                queries, args.corpus, args.corpus_scale, k_scan)
            return _refine_topk(queries, args.refine_corpus, cand, k)
        exact = self.search_mode == "exact"
        mode = "scan" if self._stage1_mode == "scan" and exact \
            else self.search_mode
        scores, ids, ok = flat_topk(
            queries, args.corpus, k_scan, metric=metric,
            corpus_sqnorm=args.corpus_sqnorm, corpus_scale=args.corpus_scale,
            corpus_bf16=args.corpus_bf16, compute_dtype=compute, mode=mode,
            corpus_center=args.corpus_center, center_sqmax=args.center_sqmax,
            corpus_bf16_lo=args.corpus_bf16_lo, return_ok=True,
        )
        if exact and mode != "scan":
            self._note_proof_verdict(ok)
        if refine:
            return _refine_topk(queries, args.refine_corpus, ids, k)
        if args.center is not None:
            # centered storage serves <q, c - mu>; restore true values
            with full_f32():
                scores = scores + (queries @ args.center)[:, None]
        return scores, ids

    def _search_mesh(self, queries, k, refine_k, metric):
        """The sharded search, routed as the JAX index routes it: int8 ->
        `sharded_int8_topk` (always refined); a data axis > 1 with at least
        as many queries -> the 2-D route; else the 1-D one."""
        from persian_rag_tpu_torch.parallel import sharded_search as ss

        sh = self._shards
        if self.storage_dtype == torch.int8:
            k_scan = min(max(refine_k or max(10 * k, 100), k), self._ntotal)
            return ss.sharded_int8_topk(
                queries, sh["corpus"], sh["scale"], sh["refine"], k,
                self._ntotal, self.mesh, k_scan=k_scan)
        dp = self.mesh.shape[DATA_AXIS]
        search = (ss.sharded_flat_topk_2d
                  if dp > 1 and queries.shape[0] >= dp
                  else ss.sharded_flat_topk)
        exact = self.search_mode == "exact"
        mode = "scan" if self._stage1_mode == "scan" and exact \
            else self.search_mode
        scores, ids = search(
            queries, sh["corpus"], k, self._ntotal, self.mesh, metric=metric,
            compute_dtype=self.compute_dtype, mode=mode,
            corpus_sqnorm_sharded=sh["sqnorm"], corpus_bf16_sharded=sh["bf16"],
            corpus_center=self._stage1_center,
            center_sqmax=sh["center_sqmax"], corpus_bf16_lo_sharded=sh["lo"],
        )
        if self._center is not None:
            # centered bf16 storage serves <q, c - mu>; restore the shift
            with full_f32():
                scores = scores + (queries @ self._center)[:, None]
        return scores, ids

    def fused_args(self) -> FusedArgs:
        """The committed corpus and its serving caches as device tensors."""
        if self._pending:
            self.commit()
        return FusedArgs(
            corpus=self._device_corpus,
            corpus_sqnorm=self._sqnorms,
            corpus_bf16=self._stage1_bf16,
            corpus_center=self._stage1_center,
            center_sqmax=self._center_sqmax,
            corpus_bf16_lo=self._stage1_lo,
            corpus_scale=self._row_scales,
            refine_corpus=self._refine_corpus,
            center=self._center,
        )

    def rows(self, row_ids) -> np.ndarray:
        """Dequantized f32 host copies of the given rows via one device
        gather."""
        a = self.fused_args()
        idx = torch.as_tensor(np.asarray(row_ids, np.int64)).to(self.device)
        return gather_rows_device(
            idx, a.corpus, a.corpus_scale, a.refine_corpus, a.center
        ).cpu().numpy()

    def vectors(self) -> np.ndarray:
        """Host copy of the committed corpus as float32 (cosine: normalized
        rows; bf16/int8 storage: the dequantized values)."""
        if self._pending:
            self.commit()
        return self._dequantized()[: self._ntotal]

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Native format: .npz payload + .meta.json sidecar."""
        if self._pending:
            self.commit()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 vectors=self.vectors())
        meta = {"dim": self.dim, "metric": self.metric, "ntotal": self._ntotal}
        with open(_meta_path(path), "w", encoding="utf-8") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, mesh=None, **kwargs) -> "DenseIndex":
        npz = path if path.endswith(".npz") else path + ".npz"
        with open(_meta_path(path), "r", encoding="utf-8") as f:
            meta = json.load(f)
        vectors = np.load(npz)["vectors"]
        index = cls(meta["dim"], metric=meta["metric"], mesh=mesh, **kwargs)
        index.add(vectors)
        index.commit()
        return index

    def export_faiss(self, path: str) -> None:
        """Write a faiss-loadable flat index file."""
        metric = "l2" if self.metric == "l2" else "ip"
        faiss_io.write_faiss_flat(path, self.vectors(), metric=metric)

    @classmethod
    def from_faiss(cls, path: str, mesh=None, **kwargs) -> "DenseIndex":
        """Import a FAISS IndexFlatL2 / IndexFlatIP file."""
        vectors, metric = faiss_io.read_faiss_flat(path)
        index = cls(vectors.shape[1], metric=metric, mesh=mesh, **kwargs)
        index.add(vectors)
        index.commit()
        return index


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"
