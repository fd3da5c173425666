"""Dense retrieval system over the port's encoder and flat index.

The counterpart of ``persian_rag_tpu.retrieval.system.RetrievalSystem``
for ``method="dense"`` with ``dense_index_type="flat"``: the same API,
the reference's 1/(1+L2) similarity mapping, budgeted RAG contexts and
Hit@K / MRR evaluation. A batch of queries is encoded and searched on the
device (`SentenceEncoder.encode_device` -> `DenseIndex.search_device`),
and its scores and ids come back to the host in one synchronised copy.

bm25, tfidf, hybrid, ivf, meshes, CSV loading and index files raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.index.dense import DenseIndex

Chunk = Dict
Result = Tuple[Chunk, float]


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to persian_rag_tpu_torch yet (ROADMAP {item})"
    )


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


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Copy device tensors to the host behind ONE synchronisation."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


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
    ):
        """
        Args:
          method: "dense" (bm25, tfidf and hybrid are not ported yet)
          encoder: a port SentenceEncoder
          dense_metric: "l2" (FAISS IndexFlatL2 scores), "ip" or "cosine"
          query_prefix/passage_prefix: e5-style instruction prefixes
        """
        if method != "dense":
            raise _todo(f"method={method!r}", "P2 (lexical and hybrid)")
        if dense_index_type != "flat":
            raise _todo(f"dense_index_type={dense_index_type!r}", "P5 (IVF)")
        if model_path is not None:
            raise _todo("loading a sentence-transformers directory",
                        "P1 c (torch HF loader)")
        if mesh is not None:
            raise _todo("a device mesh", "P7")
        self.method = method
        self.dense_metric = dense_metric
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix
        self.dense_index_type = dense_index_type
        self.embedding_model = encoder
        # the index lives on the encoder's device
        self.device = encoder.device if encoder is not None else torch.device(
            "cpu")
        self.chunks: Optional[List[Chunk]] = None
        self.dense_index: Optional[DenseIndex] = None
        self.is_ready = False

    # -- setup ---------------------------------------------------------------

    def load_chunks_and_index(
        self,
        chunks,
        faiss_index_file: Optional[str] = None,
        embeddings: Optional[np.ndarray] = None,
    ) -> bool:
        """Take a list of chunk dicts and build the dense index from
        `embeddings` (row i embeds chunk i) or by encoding the chunk texts
        with the embedding model."""
        if isinstance(chunks, str):
            raise _todo("loading chunks from a CSV path", "P6 (entry points)")
        if faiss_index_file:
            raise _todo("loading an index file", "P1 b (FAISS I/O)")
        self.chunks = list(chunks)
        texts = [str(c["text"]) for c in self.chunks]
        if embeddings is not None:
            vectors = np.asarray(embeddings, np.float32)
        elif self.embedding_model is not None:
            vectors = self.embedding_model.encode(
                [self.passage_prefix + t for t in texts]
            )
        else:
            print("dense retrieval needs embeddings or an encoder")
            return False
        self.dense_index = DenseIndex(
            vectors.shape[1], metric=self.dense_metric, device=self.device
        )
        self.dense_index.add(vectors)
        self.dense_index.commit()
        if self.dense_index.ntotal != len(self.chunks):
            print(
                f"warning: index has {self.dense_index.ntotal} vectors "
                f"but {len(self.chunks)} chunks"
            )
        self.is_ready = True
        return True

    # -- queries ---------------------------------------------------------------

    def retrieve_dense(self, query: str, top_k: int = 10) -> List[Result]:
        return self.retrieve_dense_batch([query], top_k)[0]

    def retrieve(self, query: str, top_k: int = 10) -> List[Result]:
        """Dispatch on the configured method."""
        return self.retrieve_batch([query], top_k)[0]

    def retrieve_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> List[List[Result]]:
        if not self.is_ready:
            raise RuntimeError(
                "Retrieval system is not ready; load_chunks_and_index first"
            )
        return self.retrieve_dense_batch(queries, top_k)

    def _search(
        self, queries: Sequence[str], top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode + search on the device; (scores, ids) host arrays."""
        if self.embedding_model is None:
            raise RuntimeError("no embedding model configured for dense retrieval")
        emb = self.embedding_model.encode_device(
            [self.query_prefix + q for q in queries]
        )
        scores, ids = self.dense_index.search_device(emb, top_k)
        return tuple(_to_host(scores, ids))

    def retrieve_dense_batch(
        self, queries: Sequence[str], top_k: int = 10
    ) -> List[List[Result]]:
        if self.dense_index is None or not queries:
            return [[] for _ in queries]
        scores, ids = self._search(queries, top_k)
        out: List[List[Result]] = []
        for qi in range(len(queries)):
            row: List[Result] = []
            for score, idx in zip(scores[qi], ids[qi]):
                if 0 <= idx < len(self.chunks):
                    if self.dense_metric == "l2":
                        similarity = 1.0 / (1.0 + float(score))
                    else:
                        similarity = float(score)
                    row.append((self.chunks[idx], similarity))
            out.append(row)
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
        self.chunks = None
        self.is_ready = False
