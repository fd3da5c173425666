"""Embeddings and dense indexes across all models and chunk types.

The counterpart of ``persian_rag_tpu.pipelines.create_embeddings``: discover
models (fine-tuned dirs under models/ plus the configured base names), for
each model x {word, sentence} chunk CSV encode in batches and build a dense
index (.npz + a flat FAISS file), skip when the index already exists unless
force=True, and verify all indexes by reloading them and running a test
search. Chunk CSVs are read by `read_csv_records`, not pandas. The indexes
live on `device` (None: the card).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.index.dense import DenseIndex
from persian_rag_tpu_torch.pipelines.common import build_encoder, short_name
from persian_rag_tpu_torch.retrieval.system import read_csv_records


def discover_models(config: Config) -> List[str]:
    """Fine-tuned model dirs + configured base names."""
    models: List[str] = []
    models_dir = config.paths.models_dir
    if os.path.isdir(models_dir):
        for name in sorted(os.listdir(models_dir)):
            if "finetuned" in name and os.path.isdir(
                os.path.join(models_dir, name)
            ):
                models.append(os.path.join(models_dir, name))
    models.extend(config.models)
    return models


def index_path(config: Config, model_name: str, chunk_type: str) -> str:
    return os.path.join(
        config.paths.index_dir,
        f"{short_name(model_name)}_drugs_{chunk_type}_chunks",
    )


def create_model_embeddings(
    model_name: str,
    chunk_csv: str,
    out_path: str,
    config: Config,
    mesh=None,
    tiny: bool = False,
    batch_size: int = 64,
    force: bool = False,
    device=None,
) -> Dict:
    if not force and os.path.exists(out_path + ".npz"):
        return {"skipped": True, "path": out_path}
    chunks = read_csv_records(chunk_csv)
    texts = [str(c["text"]) for c in chunks]
    encoder = build_encoder(model_name, config, mesh=mesh, tiny=tiny,
                            device=device)
    t0 = time.time()
    embeddings = encoder.encode(texts, batch_size=batch_size)
    encode_time = time.time() - t0
    index = DenseIndex(embeddings.shape[1], metric="l2", device=encoder.device,
                       mesh=mesh)
    index.add(embeddings)
    index.save(out_path)
    index.export_faiss(out_path + ".index")
    return {
        "skipped": False,
        "path": out_path,
        "num_vectors": int(index.ntotal),
        "dim": int(index.dim),
        "encode_time": encode_time,
        "docs_per_sec": len(texts) / max(encode_time, 1e-9),
    }


def verify_indices(config: Config, device=None) -> Dict[str, Dict]:
    """Reload every saved index and run a random-vector test search."""
    results: Dict[str, Dict] = {}
    index_dir = config.paths.index_dir
    if not os.path.isdir(index_dir):
        return results
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(index_dir)):
        if not name.endswith(".npz"):
            continue
        path = os.path.join(index_dir, name[:-4])
        try:
            index = DenseIndex.load(path, device=device)
            probe = rng.standard_normal((1, index.dim)).astype(np.float32)
            _, ids = index.search(probe, k=min(5, index.ntotal))
            results[name] = {
                "ok": bool((ids.cpu().numpy() >= 0).all()),
                "ntotal": index.ntotal,
                "dim": index.dim,
            }
        except Exception as e:
            results[name] = {"ok": False, "error": str(e)}
    return results


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    force: bool = False,
    verify: bool = False,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)
    if verify:
        return {"verify": verify_indices(config, device=device)}

    results: Dict = {"models": {}}
    for model_name in discover_models(config):
        per_model: Dict[str, Dict] = {}
        for chunk_type in ("word", "sentence"):
            chunk_csv = os.path.join(
                config.paths.processed_dir, f"drugs_{chunk_type}_chunks.csv"
            )
            if not os.path.exists(chunk_csv):
                continue
            out = index_path(config, model_name, chunk_type)
            per_model[chunk_type] = create_model_embeddings(
                model_name, chunk_csv, out, config,
                mesh=mesh, tiny=tiny, force=force, device=device,
            )
        results["models"][model_name] = per_model
    with open(
        os.path.join(config.paths.results_dir, "create_embeddings_results.json"),
        "w",
        encoding="utf-8",
    ) as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    return results
