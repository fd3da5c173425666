"""Phase 3 — PDF -> chunks -> embeddings -> dense indexes.

The counterpart of ``persian_rag_tpu.pipelines.phase3``: extract the corpus
PDF (or, without one, synthetic Persian text), run both chunkings, write
the chunk CSVs and statistics, encode the chunks with the chosen model
(`encode_robust`: full batch, then item by item, then zero vectors), build
and save a flat dense index and a flat FAISS file per chunk type, fill a
persistent cosine collection, smoke-test a Persian query on both, and
write the results JSON. The encoder and the indexes live on `device`
(None: the card).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.core.device import to_host
from persian_rag_tpu_torch.data.loader import DataLoader, synthetic_persian_qa
from persian_rag_tpu_torch.index.collections import CollectionStore
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.pipelines.common import build_encoder
from persian_rag_tpu_torch.text.chunking import TextChunker

SMOKE_QUERY = "دارو چیست؟"


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    pdf_path: Optional[str] = None,
    text: Optional[str] = None,
    model_name: Optional[str] = None,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)
    chunker = TextChunker(config)
    results: Dict = {"steps": {}}

    # Step 1: corpus text (PDF or direct text).
    t0 = time.time()
    if text is None:
        if pdf_path is None:
            pdf_path = os.path.join(config.paths.raw_dir, "Drugs.pdf")
        if os.path.exists(pdf_path):
            text = DataLoader().extract_pdf(pdf_path)
        else:
            # keep the pipeline runnable without the corpus PDF
            text = " ".join(r["context"] for r in synthetic_persian_qa(400))
    results["steps"]["extract"] = {
        "chars": len(text),
        "time": time.time() - t0,
    }

    # Step 2: chunk both ways.
    t0 = time.time()
    word_chunks, sentence_chunks = chunker.process_pdf_document(text)
    results["steps"]["chunking"] = {
        "word_chunks": len(word_chunks),
        "sentence_chunks": len(sentence_chunks),
        "word_stats": chunker.get_chunk_statistics(word_chunks),
        "sentence_stats": chunker.get_chunk_statistics(sentence_chunks),
        "time": time.time() - t0,
    }
    chunker.save_chunks(
        word_chunks, "drugs_word_chunks.csv", config.paths.processed_dir
    )
    chunker.save_chunks(
        sentence_chunks, "drugs_sentence_chunks.csv", config.paths.processed_dir
    )

    # Step 3: the embedding model (the first configured one by default).
    model_name = model_name or config.models[0]
    encoder = build_encoder(model_name, config, mesh=mesh, tiny=tiny,
                            device=device)

    # Steps 4-6: encode + index per chunk type.
    index_files = {}
    for chunk_type, chunks in (
        ("word", word_chunks),
        ("sentence", sentence_chunks),
    ):
        texts = [c["text"] for c in chunks]
        t0 = time.time()
        embeddings, encode_stats = encoder.encode_robust(texts, batch_size=64)
        encode_time = time.time() - t0
        t0 = time.time()
        index = DenseIndex(embeddings.shape[1], metric="l2",
                           device=encoder.device, mesh=mesh)
        index.add(embeddings)
        index.commit()
        build_time = time.time() - t0
        path = os.path.join(
            config.paths.index_dir, f"drugs_{chunk_type}_chunks"
        )
        index.save(path)
        index.export_faiss(
            os.path.join(config.paths.index_dir, f"drugs_{chunk_type}_chunks.index")
        )
        index_files[chunk_type] = path
        results["steps"][f"{chunk_type}_index"] = {
            "num_vectors": index.ntotal,
            "dim": index.dim,
            "encode_time": encode_time,
            "encode_docs_per_sec": len(texts) / max(encode_time, 1e-9),
            "encode_failures": encode_stats["failed"],
            "encode_fallback_items": encode_stats["fallback_items"],
            "index_build_time": build_time,
            "memory_mb": index.ntotal * index.dim * 4 / 1e6,
        }

        # Step 6b: a persistent cosine collection over the same vectors
        # (the reference's ChromaDB collections).
        t0 = time.time()
        store = CollectionStore(
            path=os.path.join(config.paths.index_dir, "collections"),
            device=encoder.device,
        )
        store.delete_collection(f"drugs_{chunk_type}")  # rebuild fresh
        collection = store.get_or_create_collection(
            f"drugs_{chunk_type}", metric="cosine"
        )
        collection.add(
            ids=[c["id"] for c in chunks],
            documents=texts,
            embeddings=embeddings,
            metadatas=[{"chunk_type": chunk_type} for _ in chunks],
            batch_size=500,
        )
        results["steps"][f"{chunk_type}_collection"] = {
            "count": collection.count(),
            "persist_dir": collection.persist_dir,
            "time": time.time() - t0,
        }

        # Step 7: smoke query on both the index and the collection.
        t0 = time.time()
        q_emb = encoder.encode([SMOKE_QUERY])
        distances, ids = to_host(*index.search(q_emb, k=3))
        col_out = collection.query(query_embeddings=q_emb, n_results=3)
        results["steps"][f"{chunk_type}_smoke_test"] = {
            "query": SMOKE_QUERY,
            "top_ids": [int(i) for i in ids[0]],
            "top_distances": [float(d) for d in distances[0]],
            "collection_top_ids": col_out["ids"][0],
            "time": time.time() - t0,
            "success": bool((ids[0] >= 0).all()) and bool(col_out["ids"][0]),
        }

    results["model"] = model_name
    results["index_files"] = index_files
    results["success"] = True
    out = os.path.join(
        config.paths.results_dir, "phase3_pdf_processing_results.json"
    )
    with open(out, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    return results
