"""Device-resident dense flat index (f32 storage tier).

The counterpart of ``persian_rag_tpu.index.dense.DenseIndex`` for f32
storage on one device. Semantics kept for FAISS parity:

* metric "l2" returns squared L2 distances ascending (IndexFlatL2);
  "ip" inner products descending (IndexFlatIP); "cosine" L2-normalizes the
  rows once at commit and the queries per search, then ranks by dot;
* ties prefer the lower row id; ids are insertion order.

`commit()` builds the two-stage serving caches on the device (row
sqnorms, the mean-centered bf16 stage-1 image, its max centered norm and,
for the bf16x2 stage 1, the bf16 lo residues), and a margin probe picks
the cheapest stage 1 whose proof bound clears the corpus's score gaps.
Searches return tensors on the index's device.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
bf16 and int8 storage with the quality gate, meshes, save/load, FAISS I/O.
"""
from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.ops.flat_topk import (
    TWO_STAGE_MIN_N,
    _bf16_matmul_eps,
    _bf16x2_matmul_eps,
    flat_topk,
    full_f32,
)

_METRICS = ("l2", "ip", "cosine")

logger = logging.getLogger(__name__)


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to persian_rag_tpu_torch yet (ROADMAP {item})"
    )


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


class FusedArgs(NamedTuple):
    """The f32 tier's committed corpus and its two-stage serving caches."""

    corpus: torch.Tensor  # (N, d) f32 rows (cosine: normalized)
    corpus_sqnorm: torch.Tensor  # (N,) f32 row sqnorms
    corpus_bf16: torch.Tensor  # (N, d) bf16 mean-centered stage-1 image
    corpus_center: torch.Tensor  # (d,) f32 mean the image is centered on
    center_sqmax: torch.Tensor  # () f32 max centered row sqnorm
    corpus_bf16_lo: Optional[torch.Tensor]  # (N, d) bf16 lo residues (bf16x2)


class DenseIndex:
    """Flat exact-search index over an (N, d) embedding matrix."""

    DEMOTE_STREAK = 3  # consecutive majority-fail dispatches before demotion

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        device: Union[str, torch.device] = "cpu",
        storage_dtype: torch.dtype = torch.float32,
        mesh=None,
    ):
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {metric}")
        if storage_dtype != torch.float32:
            raise _todo(f"{storage_dtype} storage", "P1 b (bf16, int8 tiers)")
        if mesh is not None:
            raise _todo("a sharded index", "P7")
        self.dim = dim
        self.metric = metric
        self.device = torch.device(device)
        self.storage_dtype = storage_dtype
        self._pending: List[np.ndarray] = []
        self._device_corpus: Optional[torch.Tensor] = None
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
            parts.append(self._device_corpus.cpu().numpy())
        parts.extend(self._pending)
        if not parts:
            raise ValueError("index is empty")
        corpus = np.concatenate(parts, axis=0)
        if self.metric == "cosine":
            corpus = _l2_normalize(corpus)
        self._pending.clear()
        self._ntotal = corpus.shape[0]
        self._fail_streak = 0

        a32 = torch.from_numpy(np.ascontiguousarray(corpus)).to(self.device)
        self._device_corpus = a32
        self._sqnorms = torch.sum(a32 * a32, dim=-1)
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
        self, queries, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch exact search of host or device queries.

        Returns (scores, ids) tensors on the index's device, each (Q, k),
        or (k,) for one 1-D query:
        * l2      -> squared distances, ascending (FAISS IndexFlatL2)
        * ip      -> inner products, descending  (FAISS IndexFlatIP)
        * cosine  -> cosine similarities, descending
        """
        if isinstance(queries, torch.Tensor):
            q = queries.float()
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32))
        squeeze = q.dim() == 1
        if squeeze:
            q = q[None, :]
        scores, ids = self.search_device(q.to(self.device), k)
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    def search_device(
        self, queries: torch.Tensor, k: int
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
        scores, ids, ok = flat_topk(
            queries,
            k=k,
            metric=metric,
            mode="scan" if self._stage1_mode == "scan" else "exact",
            return_ok=True,
            **self.fused_args()._asdict(),
        )
        self._note_proof_verdict(ok)
        return scores, ids

    def fused_args(self) -> FusedArgs:
        """The committed corpus and its serving caches as device tensors,
        named as `flat_topk` takes them."""
        if self._pending:
            self.commit()
        return FusedArgs(
            corpus=self._device_corpus,
            corpus_sqnorm=self._sqnorms,
            corpus_bf16=self._stage1_bf16,
            corpus_center=self._stage1_center,
            center_sqmax=self._center_sqmax,
            corpus_bf16_lo=self._stage1_lo,
        )

    def rows(self, row_ids) -> np.ndarray:
        """f32 host copies of the given rows via one device gather."""
        if self._pending:
            self.commit()
        idx = torch.as_tensor(np.asarray(row_ids, np.int64)).to(self.device)
        return self._device_corpus[idx].cpu().numpy()

    def vectors(self) -> np.ndarray:
        """Host copy of the committed corpus (cosine: normalized rows)."""
        if self._pending:
            self.commit()
        return self._device_corpus.cpu().numpy()

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        raise _todo("DenseIndex.save", "P1 b (save/load)")

    @classmethod
    def load(cls, path: str, **kwargs) -> "DenseIndex":
        raise _todo("DenseIndex.load", "P1 b (save/load)")

    def export_faiss(self, path: str) -> None:
        raise _todo("DenseIndex.export_faiss", "P1 b (FAISS I/O)")

    @classmethod
    def from_faiss(cls, path: str, **kwargs) -> "DenseIndex":
        raise _todo("DenseIndex.from_faiss", "P1 b (FAISS I/O)")
