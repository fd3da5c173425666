"""Phase 4 — end-to-end RAG evaluation.

The counterpart of ``persian_rag_tpu.pipelines.phase4``: prerequisite
checks, the LLM connectivity probe, then for each chunk type and retrieval
method the retrieve -> generate -> score loop of `RAGEvaluator`, a
per-chunk-type comparison, and timestamped JSON and markdown reports
under ``paths.results_dir``. Methods default to bm25 and tfidf; dense and
hybrid share one encoder (the first configured model) on `device` (None:
the card). The chunk CSVs and ``test_data.csv`` are read by
`read_csv_records`; without chunk CSVs it raises FileNotFoundError.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.eval.evaluator import RAGEvaluator
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.pipelines.common import build_encoder
from persian_rag_tpu_torch.retrieval.system import (
    RetrievalSystem,
    read_csv_records,
)


def check_prerequisites(config: Config) -> Dict[str, bool]:
    processed = config.paths.processed_dir
    return {
        "word_chunks": os.path.exists(
            os.path.join(processed, "drugs_word_chunks.csv")
        ),
        "sentence_chunks": os.path.exists(
            os.path.join(processed, "drugs_sentence_chunks.csv")
        ),
        "test_data": os.path.exists(os.path.join(processed, "test_data.csv")),
    }


def run_single_method_evaluation(
    evaluator: RAGEvaluator,
    chunks,
    method: str,
    test_data: List[Dict],
    sample_size: Optional[int],
    encoder=None,
    mesh=None,
    device=None,
) -> Dict:
    retriever = RetrievalSystem(method=method, encoder=encoder, mesh=mesh,
                                device=device)
    if not retriever.load_chunks_and_index(chunks):
        return {}
    try:
        return evaluator.evaluate_single_rag(
            retriever,
            test_data,
            model_name=method,
            sample_size=sample_size,
        )
    finally:
        retriever.cleanup()


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    methods: Optional[List[str]] = None,
    test_data: Optional[List[Dict]] = None,
    chunks_by_type: Optional[Dict[str, List[Dict]]] = None,
    llama_client: Optional[LlamaClient] = None,
    sample_size: Optional[int] = None,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)
    methods = methods or ["bm25", "tfidf"]
    sample_size = sample_size or config.evaluation.sample_size

    if chunks_by_type is None:
        prereq = check_prerequisites(config)
        chunks_by_type = {}
        for chunk_type in ("word", "sentence"):
            path = os.path.join(
                config.paths.processed_dir, f"drugs_{chunk_type}_chunks.csv"
            )
            if prereq[f"{chunk_type}_chunks"]:
                chunks_by_type[chunk_type] = read_csv_records(path)
    if not chunks_by_type:
        raise FileNotFoundError(
            "no chunk CSVs found under "
            f"{config.paths.processed_dir}: run phase3 first"
        )
    if test_data is None:
        test_csv = os.path.join(config.paths.processed_dir, "test_data.csv")
        if os.path.exists(test_csv):
            test_data = read_csv_records(test_csv)
        else:
            from persian_rag_tpu_torch.data.loader import synthetic_persian_qa

            test_data = synthetic_persian_qa(200, seed=11)

    evaluator = RAGEvaluator(
        llama_url=config.generation.server_url, llama_client=llama_client
    )
    connectivity = evaluator.llama_client.get_server_info()

    encoder = None
    if any(m in ("dense", "hybrid") for m in methods):
        encoder = build_encoder(config.models[0], config, mesh=mesh,
                                tiny=tiny, device=device)

    results: Dict = {
        "evaluation_metadata": {
            "timestamp": datetime.datetime.now().isoformat(),
            "models_evaluated": methods,
            "num_test_questions": min(sample_size or len(test_data), len(test_data)),
            "chunk_types": list(chunks_by_type.keys()),
            "enhancement": "tpu-native batched retrieval",
            "llm_connectivity": connectivity["status"],
        }
    }
    for chunk_type, chunks in chunks_by_type.items():
        performances = {}
        for method in methods:
            performance = run_single_method_evaluation(
                evaluator,
                chunks,
                method,
                test_data,
                sample_size,
                encoder=encoder if method in ("dense", "hybrid") else None,
                mesh=mesh,
                device=device,
            )
            if performance:
                performances[method] = performance
                results[f"{chunk_type}_{method}_results"] = performance
        results[f"{chunk_type}_chunks_comparison"] = (
            evaluator._analyze_model_comparison(performances)
        )

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    json_path = evaluator.save_evaluation_results(
        results,
        f"phase4_rag_evaluation_{stamp}.json",
        directory=config.paths.results_dir,
    )
    report = evaluator.create_evaluation_report(results)
    report_path = os.path.join(
        config.paths.results_dir, f"phase4_rag_report_{stamp}.md"
    )
    with open(report_path, "w", encoding="utf-8") as f:
        f.write(report)
    results["artifacts"] = {"json": json_path, "report": report_path}
    return results
