"""Retrieval system: dense | bm25 | tfidf | hybrid.

The counterpart of ``persian_rag_tpu.retrieval.system.RetrievalSystem``
with ``dense_index_type="flat"``: the same API and semantics.

* dense  -- `DenseIndex`, the reference's 1/(1+L2) similarity mapping;
* bm25   -- `BM25Index`, raw Okapi scores descending;
* tfidf  -- `TfidfIndex`, cosine descending;
* hybrid -- dense and BM25 each at 2k, per-channel max-normalisation and a
  0.6/0.4 weighted sum, optionally reranked by exact cosine on the stored
  rows. The device path is one chain on the index's device (encode ->
  dense search -> lexical top-k -> `fuse_hybrid` -> `rerank_cosine`) with
  one host copy at the end; `fused=False` keeps the host fusion loop.

A batch of queries is searched on the device and its scores and ids come
back to the host in one synchronised copy. Unlike the JAX package, a
hybrid system builds no TF-IDF index (its retrieval never reads one).

`dense_index_type="ivf"` builds an `IVFIndex` (`ivf_cells`, `ivf_nprobe`,
`ivf_target_recall`), searched like the flat index; the hybrid device
chain stays flat-only, as the JAX package's fused path does, so an IVF
hybrid system fuses on the host and reranks on `IVFIndex.rows`.

`load_chunks_and_index(..., faiss_index_file=)` serves a saved index: a
native `.npz` (`DenseIndex.save`), a flat FAISS file or an IVF-flat one,
and it takes its chunks from a list of dicts or a CSV path
(`read_csv_records`, the records pandas' `read_csv(...).to_dict("records")`
gives). With a `mesh` (``core.mesh``) every index the system builds or
loads shards over the mesh's corpus axis, the encoder (built by the
caller, or loaded from `model_path` onto the mesh) encodes data-parallel,
and the indexes live on the mesh's first device; the hybrid device chain
stays single-device, as the JAX package's fused paths do, so a mesh
hybrid system fuses on the host.

`MultiModelRetrieval` builds one dense system per encoder over the same
chunks and compares their Hit@{1,3,5} and MRR@10.
"""
from __future__ import annotations

import csv
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from persian_rag_tpu_torch.core.device import resolve_device, to_host
from persian_rag_tpu_torch.core.mesh import check_mesh
from persian_rag_tpu_torch.index import faiss_io
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.index.ivf import IVFIndex
from persian_rag_tpu_torch.index.lexical import BM25Index, TfidfIndex
from persian_rag_tpu_torch.ops.hybrid_fusion import (
    fuse_hybrid,
    gather_rows_device,
    rerank_cosine,
)

Chunk = Dict
Result = Tuple[Chunk, float]
_METHODS = ("dense", "bm25", "tfidf", "hybrid")


# pandas' default na_values: a cell that reads as one of these is NaN
_NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT_CELL = re.compile(r"^\s*[+-]?[0-9]+\s*$")
_FLOAT_CELL = re.compile(
    r"^\s*[+-]?(?:[0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?|\.[0-9]+"
    r"(?:[eE][+-]?[0-9]+)?|inf|infinity)\s*$", re.I)
_BOOL_CELLS = {"True": True, "TRUE": True, "true": True, "False": False,
               "FALSE": False, "false": False}


def _typed_column(cells: List[Optional[str]]) -> List:
    """A column typed as pandas' C parser types it: integers (float, NaN
    for a missing cell, where any is missing), else floats, else booleans
    (object with NaN where missing), else strings (NaN where missing)."""
    present = [c for c in cells if c is not None]
    nan = float("nan")
    if present and all(_INT_CELL.match(c) for c in present):
        if len(present) == len(cells):
            return [int(c) for c in cells]
        return [nan if c is None else float(int(c)) for c in cells]
    if present and all(_FLOAT_CELL.match(c) for c in present):
        return [nan if c is None else float(c) for c in cells]
    if present and all(c in _BOOL_CELLS for c in present):
        return [nan if c is None else _BOOL_CELLS[c] for c in cells]
    return [nan if c is None else c for c in cells]


def read_csv_records(path: str) -> List[Dict]:
    """The rows of a CSV file with a header line, as the records that
    `pd.read_csv(path, encoding="utf-8").to_dict("records")` gives for the
    chunk files the JAX package writes: quoting by the csv module, blank
    lines skipped, duplicate names numbered (a, a.1) and empty ones
    "Unnamed: i", pandas' NA strings as NaN, short rows padded with NaN,
    and each column typed as pandas types it (`_typed_column`)."""
    with open(path, "r", encoding="utf-8-sig", newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    names: List[str] = []
    for i, name in enumerate(rows[0]):
        name = name or f"Unnamed: {i}"
        base, n = name, 0
        while name in names:
            n += 1
            name = f"{base}.{n}"
        names.append(name)
    width = len(names)
    columns: List[List[Optional[str]]] = [[] for _ in names]
    for line, row in enumerate(rows[1:], start=2):
        if len(row) > width:
            raise ValueError(f"{path}: row {line} has {len(row)} fields, "
                             f"the header {width}")
        for j in range(width):
            cell = row[j] if j < len(row) else ""
            columns[j].append(None if cell in _NA_VALUES else cell)
    typed = [_typed_column(c) for c in columns]
    return [dict(zip(names, values)) for values in zip(*typed)]


def assemble_contexts(
    results: Sequence[Result], max_context_length: int = 2000
) -> Tuple[List[str], List[Dict]]:
    """Character-budgeted context assembly with truncation-with-'...'."""
    contexts: List[str] = []
    metadata: List[Dict] = []
    total = 0
    for chunk, score in results:
        text = str(chunk["text"])
        if total + len(text) > max_context_length:
            remaining = max_context_length - total
            if remaining > 100:
                text = text[:remaining] + "..."
            else:
                break
        contexts.append(text)
        metadata.append(
            {
                "chunk_id": chunk["id"],
                "score": score,
                "chunk_type": chunk.get("chunk_type", "unknown"),
                "length": len(text),
            }
        )
        total += len(text)
        if total >= max_context_length:
            break
    return contexts, metadata


class RetrievalSystem:
    def __init__(
        self,
        method: str = "dense",
        encoder=None,
        model_path: Optional[str] = None,
        mesh=None,
        dense_metric: str = "l2",
        query_prefix: str = "",
        passage_prefix: str = "",
        dense_index_type: str = "flat",
        ivf_cells: int = 100,
        ivf_nprobe: int = 8,
        ivf_target_recall: Optional[float] = None,
        device=None,
    ):
        """
        Args:
          method: "dense" | "bm25" | "tfidf" | "hybrid"
          encoder: a port SentenceEncoder (None for lexical-only methods)
          model_path: a local sentence-transformers directory, loaded
            when no encoder is given for "dense" / "hybrid"
          dense_metric: "l2" (FAISS IndexFlatL2 scores), "ip" or "cosine"
          query_prefix/passage_prefix: e5-style instruction prefixes
          dense_index_type: "flat" (DenseIndex) or "ivf" (IVFIndex with
            min(ivf_cells, N // 4) cells and ivf_nprobe, or the nprobe
            calibrated to ivf_target_recall at build)
          mesh: a `core.mesh.Mesh` to shard the indexes over (its first
            device is then the system's device)
          device: where the indexes live; default the encoder's device,
            else the card (raises without CUDA). "cpu" asks for the CPU.
        """
        if method not in _METHODS:
            raise ValueError(f"unknown retrieval method: {method}")
        if dense_index_type not in ("flat", "ivf"):
            raise ValueError(f"unknown dense_index_type: {dense_index_type}")
        self.mesh = check_mesh(mesh)
        self.method = method
        self.dense_metric = dense_metric
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix
        self.dense_index_type = dense_index_type
        self.ivf_cells = ivf_cells
        self.ivf_nprobe = ivf_nprobe
        self.ivf_target_recall = ivf_target_recall
        if encoder is None and model_path and method in ("dense", "hybrid"):
            from persian_rag_tpu_torch.models.sentence_encoder import (
                SentenceEncoder,
            )

            encoder = SentenceEncoder.from_pretrained(model_path,
                                                      device=device,
                                                      mesh=mesh)
        self.embedding_model = encoder
        if mesh is not None:
            self.device = mesh.device
        elif device is None and encoder is not None:
            self.device = encoder.device
        else:
            self.device = resolve_device(device)
        self.chunks: Optional[List[Chunk]] = None
        self.dense_index: Optional[Union[DenseIndex, IVFIndex]] = None
        self.bm25_index: Optional[BM25Index] = None
        self.tfidf_index: Optional[TfidfIndex] = None
        self._id_to_row: Optional[Dict] = None
        self._rows_match_encoder = False
        self.is_ready = False

    # -- setup ---------------------------------------------------------------

    def load_chunks_and_index(
        self,
        chunks,
        faiss_index_file: Optional[str] = None,
        embeddings: Optional[np.ndarray] = None,
        embeddings_from_encoder: bool = True,
    ) -> bool:
        """Take a list of chunk dicts and build the method's indexes.

        Dense vectors come from, in priority order: `embeddings` (row i
        embeds chunk i), an index file (`faiss_index_file`: a native .npz
        or a flat FAISS file; the index's metric becomes `dense_metric`),
        or encoding the chunk texts. embeddings_from_encoder=True asserts
        that `embeddings` came from THIS system's encoder, which lets
        rerank use the stored rows; pass False for foreign vectors (rerank
        then re-encodes the candidate texts). Rows loaded from an index
        file are always treated as foreign: their provenance is unknown.
        A string `chunks` is a CSV path (`read_csv_records`)."""
        if isinstance(chunks, str):
            chunks = read_csv_records(chunks)
        self.chunks = list(chunks)
        texts = [str(c["text"]) for c in self.chunks]
        # chunk id -> dense row, for the rerank fast path (unique ids only:
        # positions and index rows coincide, the index is built in order)
        ids_seen = [c.get("id") for c in self.chunks]
        self._id_to_row = (
            {cid: i for i, cid in enumerate(ids_seen)}
            if None not in ids_seen and len(set(ids_seen)) == len(ids_seen)
            else None
        )
        self._rows_match_encoder = False
        if self.method in ("dense", "hybrid"):
            if embeddings is not None:
                self._build_dense(np.asarray(embeddings, np.float32))
                self._rows_match_encoder = bool(embeddings_from_encoder)
            elif faiss_index_file:
                where = dict(device=self.device, mesh=self.mesh)
                if faiss_index_file.endswith(".npz"):
                    self.dense_index = DenseIndex.load(
                        faiss_index_file, **where)
                elif faiss_io.probe_faiss(faiss_index_file) == "ivf":
                    self.dense_index = IVFIndex.from_faiss(
                        faiss_index_file, **where)
                else:
                    self.dense_index = DenseIndex.from_faiss(
                        faiss_index_file, **where)
                self.dense_metric = self.dense_index.metric
            elif self.embedding_model is not None:
                self._build_dense(self.embedding_model.encode(
                    [self.passage_prefix + t for t in texts]
                ))
                self._rows_match_encoder = True
            else:
                print("dense retrieval needs embeddings, an index file, "
                      "or an encoder")
                return False
            if self.dense_index.ntotal != len(self.chunks):
                print(
                    f"warning: index has {self.dense_index.ntotal} vectors "
                    f"but {len(self.chunks)} chunks"
                )
        if self.method in ("bm25", "hybrid"):
            self.bm25_index = BM25Index(
                mesh=self.mesh, device=self.device).build(texts)
        if self.method == "tfidf":
            self.tfidf_index = TfidfIndex(
                mesh=self.mesh, device=self.device).build(texts)
        self.is_ready = True
        return True

    def _build_dense(self, vectors: np.ndarray) -> None:
        if self.dense_index_type == "ivf":
            self.dense_index = IVFIndex(
                vectors.shape[1],
                n_cells=min(self.ivf_cells, max(1, vectors.shape[0] // 4)),
                nprobe=self.ivf_nprobe,
                metric=self.dense_metric,
                target_recall=self.ivf_target_recall,
                device=self.device,
                mesh=self.mesh,
            ).build(vectors)
            return
        self.dense_index = DenseIndex(
            vectors.shape[1], metric=self.dense_metric, device=self.device,
            mesh=self.mesh,
        )
        self.dense_index.add(vectors)
        self.dense_index.commit()

    # -- single-query paths ----------------------------------------------------

    def retrieve_dense(self, query: str, top_k: int = 10) -> List[Result]:
        return self.retrieve_dense_batch([query], top_k)[0]

    def retrieve_bm25(self, query: str, top_k: int = 10) -> List[Result]:
        return self.retrieve_bm25_batch([query], top_k)[0]

    def retrieve_tfidf(self, query: str, top_k: int = 10) -> List[Result]:
        return self.retrieve_tfidf_batch([query], top_k)[0]

    def retrieve_hybrid(
        self,
        query: str,
        top_k: int = 10,
        dense_weight: float = 0.6,
        bm25_weight: float = 0.4,
    ) -> List[Result]:
        return self.retrieve_hybrid_batch(
            [query], top_k, dense_weight, bm25_weight
        )[0]

    def retrieve(self, query: str, top_k: int = 10) -> List[Result]:
        """Dispatch on the configured method."""
        return self.retrieve_batch([query], top_k)[0]

    # -- batched paths -----------------------------------------------------------

    def retrieve_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> List[List[Result]]:
        if not self.is_ready:
            raise RuntimeError(
                "Retrieval system is not ready; load_chunks_and_index first"
            )
        if self.method == "dense":
            return self.retrieve_dense_batch(queries, top_k)
        if self.method == "bm25":
            return self.retrieve_bm25_batch(queries, top_k)
        if self.method == "tfidf":
            return self.retrieve_tfidf_batch(queries, top_k)
        return self.retrieve_hybrid_batch(queries, top_k)

    def top_k_depth(self, top_k: int) -> int:
        """How deep the answer at top_k reaches: requests whose top_k have
        one depth get one retrieve_batch at the larger top_k, cut to their
        own (RetrievalServer serves them together). An exact list (dense
        f32 / bf16 / raw int8, BM25, TF-IDF) is the head of every deeper
        one up to near-ties: 0. (Two rows whose scores differ by f32
        rounding may swap: the two-stage proof's verdict, and so whether a
        query is answered by the refine or by the f32 rescan of its
        256-query slice, depends on k and on the slice's other queries, and
        a large lexical batch takes the union kernels' summation order.) A
        hybrid list fuses both channels over-retrieved at 2 top_k: top_k.
        An int8 tier with a refine copy re-ranks max(10 top_k, 100)
        candidates. An IVF list ranks the same probed cells at every depth:
        0."""
        if self.method == "hybrid":
            return top_k
        index = self.dense_index
        if (self.method == "dense" and isinstance(index, DenseIndex)
                and index.storage_dtype == torch.int8
                and index.refine_dtype is not None):
            return max(10 * top_k, 100)
        return 0

    def _encode_device(self, queries: Sequence[str]) -> torch.Tensor:
        if self.embedding_model is None:
            raise RuntimeError("no embedding model configured for dense retrieval")
        return self.embedding_model.encode_device(
            [self.query_prefix + q for q in queries]
        )

    def _search(
        self, queries: Sequence[str], top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode + search on the device; (scores, ids) host arrays."""
        scores, ids = self.dense_index.search_device(
            self._encode_device(queries), top_k)
        return tuple(to_host(scores, ids))

    def _rows(self, scores, ids, similarity=float) -> List[List[Result]]:
        return [
            [
                (self.chunks[idx], similarity(score))
                for score, idx in zip(s_row, i_row)
                if 0 <= idx < len(self.chunks)
            ]
            for s_row, i_row in zip(scores, ids)
        ]

    def retrieve_dense_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> List[List[Result]]:
        if self.dense_index is None or not queries:
            return [[] for _ in queries]
        scores, ids = self._search(queries, top_k)
        if self.dense_metric == "l2":
            return self._rows(scores, ids, lambda s: 1.0 / (1.0 + float(s)))
        return self._rows(scores, ids)

    def _lexical_batch(
        self, index, queries: Sequence[str], top_k: int
    ) -> List[List[Result]]:
        if index is None or not queries:
            return [[] for _ in queries]
        scores, ids = index.search(list(queries), top_k)
        return self._rows(scores, ids)

    def retrieve_bm25_batch(self, queries, top_k: int = 10):
        return self._lexical_batch(self.bm25_index, queries, top_k)

    def retrieve_tfidf_batch(self, queries, top_k: int = 10):
        return self._lexical_batch(self.tfidf_index, queries, top_k)

    # -- hybrid --------------------------------------------------------------------

    def _hybrid_fused_supported(self) -> bool:
        """The device chain needs one device (no mesh), an encoder, a flat
        dense index, BM25 and unique chunk ids (device row ids must be
        chunk positions for the id-keyed dedup)."""
        return (
            self.mesh is None
            and self.embedding_model is not None
            and isinstance(self.dense_index, DenseIndex)
            and self.bm25_index is not None
            and self._id_to_row is not None
        )

    def _retrieve_hybrid_fused(
        self,
        queries: Sequence[str],
        top_k: int,
        dense_weight: float,
        bm25_weight: float,
        rerank: bool,
    ) -> List[List[Result]]:
        """encode -> dense top-2k -> lexical top-2k -> fusion (-> cosine
        rerank on the stored rows), all on the device, one host copy."""
        bm = self.bm25_index
        n = self.dense_index.ntotal
        k = min(top_k, n)
        m_d = min(top_k * 2, n)
        m_b = min(top_k * 2, bm.ntotal)
        emb = self._encode_device(queries)
        d_s, d_i = self.dense_index.search_device(emb, m_d)
        # the union kernels serve over-retrieves up to 32 (as in the JAX
        # package's fused hybrid step); wider ones keep the per-term kernels
        l_s, l_i = bm._search_device(
            [bm._query_terms(q) for q in queries], m_b,
            allow_union=m_b <= 32,
        )
        f_s, f_i = fuse_hybrid(
            d_s, d_i, l_s, l_i, k,
            dense_weight=dense_weight, bm25_weight=bm25_weight,
            dense_sim="l2" if self.dense_metric == "l2" else "sim",
        )
        if rerank:
            a = self.dense_index.fused_args()
            rows = gather_rows_device(
                f_i, a.corpus, a.corpus_scale, a.refine_corpus, a.center)
            f_s, f_i = rerank_cosine(emb, rows, f_s, f_i)
        return self._rows(*to_host(f_s, f_i))

    def _candidate_embeddings(
        self, candidates: List[List[Result]], flat_texts: List[str]
    ) -> np.ndarray:
        """Embeddings of rerank candidates, flattened in span order: the
        stored dense rows when they are known to come from this system's
        encoder and every candidate id maps to a row, else re-encoded."""
        id_map = self._id_to_row
        if (
            self.dense_index is not None
            and id_map is not None
            and self._rows_match_encoder
        ):
            rows = [
                id_map.get(c.get("id"))
                for cands in candidates
                for c, _ in cands
            ]
            if None not in rows:
                return self.dense_index.rows(np.asarray(rows, np.int64))
        return self.embedding_model.encode(flat_texts)

    def rerank_batch(
        self, queries: Sequence[str], candidates: List[List[Result]]
    ) -> List[List[Result]]:
        """Re-score fused candidates with exact dense cosine similarity
        and re-sort (stable, so ties keep the fused order)."""
        if self.embedding_model is None:
            return candidates
        flat_texts: List[str] = []
        spans: List[Tuple[int, int]] = []
        for cands in candidates:
            start = len(flat_texts)
            flat_texts.extend(
                self.passage_prefix + str(c["text"]) for c, _ in cands
            )
            spans.append((start, len(flat_texts)))
        if not flat_texts:
            return candidates
        q_emb = self.embedding_model.encode(
            [self.query_prefix + q for q in queries])
        c_emb = self._candidate_embeddings(candidates, flat_texts)
        out: List[List[Result]] = []
        for qi, (start, end) in enumerate(spans):
            if start == end:
                out.append([])
                continue
            emb = c_emb[start:end]
            q = q_emb[qi]
            denom = np.maximum(
                np.linalg.norm(emb, axis=1) * np.linalg.norm(q), 1e-12
            )
            sims = emb @ q / denom
            order = np.argsort(-sims, kind="stable")
            out.append(
                [(candidates[qi][i][0], float(sims[i])) for i in order]
            )
        return out

    def retrieve_hybrid_batch(
        self,
        queries: Sequence[str],
        top_k: int = 10,
        dense_weight: float = 0.6,
        bm25_weight: float = 0.4,
        rerank: bool = False,
        fused: Optional[bool] = None,
    ) -> List[List[Result]]:
        """Over-retrieve both channels at 2k, max-normalise per channel,
        weighted-sum, re-sort; rerank=True re-scores the fused top-k with
        exact dense cosine. fused=None takes the device chain when it is
        supported (and, with rerank, when the stored rows come from this
        encoder); fused=False forces the host fusion loop."""
        if not queries:
            return []
        if fused is None:
            fused = self._hybrid_fused_supported()
        # the device rerank gathers STORED rows: same provenance contract
        # as the host fast path (_candidate_embeddings)
        rerank_ok = not rerank or self._rows_match_encoder
        if fused and self._hybrid_fused_supported() and rerank_ok:
            return self._retrieve_hybrid_fused(
                queries, top_k, dense_weight, bm25_weight, rerank
            )
        dense = self.retrieve_dense_batch(queries, top_k * 2)
        bm25 = self.retrieve_bm25_batch(queries, top_k * 2)
        out: List[List[Result]] = []
        for qi in range(len(queries)):
            combined: Dict[str, Dict] = {}
            if dense[qi]:
                max_d = max(s for _, s in dense[qi])
                for chunk, score in dense[qi]:
                    norm = score / max_d if max_d > 0 else 0.0
                    combined[chunk["id"]] = {
                        "chunk": chunk,
                        "dense": norm * dense_weight,
                        "bm25": 0.0,
                    }
            if bm25[qi]:
                max_b = max(s for _, s in bm25[qi])
                for chunk, score in bm25[qi]:
                    norm = score / max_b if max_b > 0 else 0.0
                    entry = combined.setdefault(
                        chunk["id"], {"chunk": chunk, "dense": 0.0, "bm25": 0.0}
                    )
                    entry["bm25"] = norm * bm25_weight
            fused_rows = [
                (e["chunk"], e["dense"] + e["bm25"]) for e in combined.values()
            ]
            fused_rows.sort(key=lambda x: x[1], reverse=True)
            out.append(fused_rows[:top_k])
        if rerank:
            out = self.rerank_batch(queries, out)
        return out

    # -- RAG context assembly ----------------------------------------------------

    def get_contexts_for_rag(
        self, query: str, top_k: int = 5, max_context_length: int = 2000
    ) -> Tuple[List[str], List[Dict]]:
        """Budgeted context assembly."""
        results = self.retrieve(query, top_k)
        return assemble_contexts(results, max_context_length)

    # -- built-in retrieval eval ---------------------------------------------------

    def evaluate_retrieval_quality(
        self,
        test_queries: List[Dict],
        relevant_chunks: Dict[str, List[str]],
        batch_size: int = 64,
    ) -> Dict[str, float]:
        """Hit@{1,3,5} and MRR@10, batched on the device."""
        hit1, hit3, hit5, mrrs = [], [], [], []
        evaluated = []
        for i, qd in enumerate(test_queries):
            qid = qd.get("id", str(i))
            if relevant_chunks.get(qid):
                evaluated.append((qd["question"], relevant_chunks[qid]))
        for start in range(0, len(evaluated), batch_size):
            batch = evaluated[start : start + batch_size]
            results = self.retrieve_batch([q for q, _ in batch], top_k=10)
            for (query, relevant), res in zip(batch, results):
                ids = [chunk["id"] for chunk, _ in res]
                hit1.append(any(c in relevant for c in ids[:1]))
                hit3.append(any(c in relevant for c in ids[:3]))
                hit5.append(any(c in relevant for c in ids[:5]))
                mrr = 0.0
                for rank, cid in enumerate(ids, 1):
                    if cid in relevant:
                        mrr = 1.0 / rank
                        break
                mrrs.append(mrr)
        return {
            "hit_at_1": float(np.mean(hit1)) if hit1 else 0.0,
            "hit_at_3": float(np.mean(hit3)) if hit3 else 0.0,
            "hit_at_5": float(np.mean(hit5)) if hit5 else 0.0,
            "mrr": float(np.mean(mrrs)) if mrrs else 0.0,
            "total_queries": len(test_queries),
        }

    def cleanup(self) -> None:
        """Release references."""
        self.embedding_model = None
        self.dense_index = None
        self.bm25_index = None
        self.tfidf_index = None
        self.chunks = None
        self.is_ready = False


class MultiModelRetrieval:
    """Several embedding models over one corpus: one dense
    `RetrievalSystem` per encoder (each on its encoder's device unless
    `device` is given, or sharded over `mesh`), compared by
    `evaluate_retrieval_quality`."""

    def __init__(self, encoders: Dict[str, object], mesh=None, device=None):
        self.mesh = check_mesh(mesh)
        self.encoders = encoders
        self.device = device
        self.retrievers: Dict[str, RetrievalSystem] = {}

    def setup_retrievers(
        self, chunk_file, indices: Optional[Dict[str, str]] = None
    ) -> None:
        for name, encoder in self.encoders.items():
            retriever = RetrievalSystem(
                method="dense", encoder=encoder, mesh=self.mesh,
                device=self.device,
            )
            index_file = (indices or {}).get(name)
            if retriever.load_chunks_and_index(chunk_file, index_file):
                self.retrievers[name] = retriever

    def compare_retrieval_performance(
        self, test_queries: List[Dict], relevant_chunks: Dict[str, List[str]]
    ) -> Dict[str, Dict]:
        return {
            name: r.evaluate_retrieval_quality(test_queries, relevant_chunks)
            for name, r in self.retrievers.items()
        }

    def cleanup_all(self) -> None:
        for retriever in self.retrievers.values():
            retriever.cleanup()
        self.retrievers.clear()
