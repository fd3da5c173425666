"""Phase 4 (enhanced) — per-model dense RAG evaluation with rank metrics.

The counterpart of ``persian_rag_tpu.pipelines.phase4_enhanced``: for each
configured embedding model a dense index over the word chunks on `device`
(None: the card), Hit@K / Precision@K / Recall@K for K in `K_GRID` and
MRR@10 against gold-context relevance, then the whole generation metric
suite of `RAGEvaluator`. A chunk is relevant to a question when its
tokens Jaccard-match the question's gold context at 0.35 or more.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.eval.evaluator import RAGEvaluator
from persian_rag_tpu_torch.eval.metrics import TextMetrics, hit_at_k, mrr_at_k
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.pipelines.common import (
    build_encoder,
    prefixes_for,
    short_name,
)
from persian_rag_tpu_torch.retrieval.system import (
    RetrievalSystem,
    read_csv_records,
)

K_GRID = (1, 3, 5, 10)


def find_relevant_chunks(
    chunks: List[Dict],
    test_data: List[Dict],
    metrics: Optional[TextMetrics] = None,
    threshold: float = 0.35,
) -> Dict[int, List[str]]:
    """Question index -> the ids of the chunks whose tokens overlap its
    gold context (token Jaccard >= `threshold`), in chunk order.

    The chunks' token sets are laid out once as flat token indices with
    offsets, so each question takes one gather and one segment sum over
    them; the ratios are the JAX loop's (int counts, float64 division)."""
    metrics = metrics or TextMetrics()
    token_sets = [set(metrics.tokenize(str(c["text"]))) for c in chunks]
    vocab: Dict[str, int] = {}
    flat = [vocab.setdefault(t, len(vocab)) for ts in token_sets for t in ts]
    sizes = np.array([len(ts) for ts in token_sets], np.int64)
    row = np.repeat(np.arange(len(chunks)), sizes)
    flat = np.asarray(flat, np.int64)
    held = np.nonzero(sizes)[0]
    relevant: Dict[int, List[str]] = {}
    for qi, item in enumerate(test_data):
        gold = set(metrics.tokenize(str(item.get("context") or "")))
        if not gold:
            continue
        in_gold = np.zeros(len(vocab) + 1, bool)
        in_gold[[vocab[t] for t in gold if t in vocab]] = True
        inter = np.bincount(row, weights=in_gold[flat],
                            minlength=len(chunks)).astype(np.int64)
        union = sizes + len(gold) - inter
        ok = inter[held] / union[held] >= threshold
        ids = [chunks[i]["id"] for i in held[ok]]
        if ids:
            relevant[qi] = ids
    return relevant


def evaluate_model(
    model_name: str,
    chunks: List[Dict],
    test_data: List[Dict],
    evaluator: RAGEvaluator,
    config: Config,
    mesh=None,
    tiny: bool = False,
    sample_size: Optional[int] = None,
    device=None,
) -> Dict:
    encoder = build_encoder(model_name, config, mesh=mesh, tiny=tiny,
                            device=device)
    prefixes = prefixes_for(model_name)
    retriever = RetrievalSystem(
        method="dense",
        encoder=encoder,
        mesh=mesh,
        query_prefix=prefixes["query_prefix"],
        passage_prefix=prefixes["passage_prefix"],
        device=device,
    )
    if not retriever.load_chunks_and_index(chunks):
        return {}
    name = short_name(model_name)
    items = test_data[: sample_size or len(test_data)]

    # rank metrics against gold-context relevance
    relevant = find_relevant_chunks(chunks, items)
    hits = {k: [] for k in K_GRID}
    precs = {k: [] for k in K_GRID}
    recalls = {k: [] for k in K_GRID}
    mrrs = []
    if relevant:
        questions = [items[qi]["question"] for qi in relevant]
        batched = retriever.retrieve_batch(questions, top_k=max(K_GRID))
        for (qi, rel_ids), res in zip(relevant.items(), batched):
            ids = [c["id"] for c, _ in res]
            held = set(rel_ids)  # chunk ids are unique: len(held) = len(rel_ids)
            mrrs.append(mrr_at_k(ids, held, 10))
            for k in K_GRID:
                top = ids[:k]
                hits[k].append(hit_at_k(ids, held, k))
                got = sum(1 for c in top if c in held)
                precs[k].append(got / k)
                recalls[k].append(got / len(rel_ids))

    results = {}
    for k in K_GRID:
        results[f"{name}_hit_at_{k}"] = float(np.mean(hits[k])) if hits[k] else 0.0
        results[f"{name}_precision_at_{k}"] = (
            float(np.mean(precs[k])) if precs[k] else 0.0
        )
        results[f"{name}_recall_at_{k}"] = (
            float(np.mean(recalls[k])) if recalls[k] else 0.0
        )
    results[f"{name}_mrr_at_10"] = float(np.mean(mrrs)) if mrrs else 0.0
    results[f"{name}_relevance_queries"] = len(relevant)

    # the whole generation metric suite
    results.update(
        evaluator.evaluate_single_rag(
            retriever, items, model_name=name, eval_encoder=encoder
        )
    )
    retriever.cleanup()
    return results


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    chunks: Optional[List[Dict]] = None,
    test_data: Optional[List[Dict]] = None,
    llama_client: Optional[LlamaClient] = None,
    sample_size: Optional[int] = None,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)
    sample_size = sample_size or config.evaluation.sample_size

    if chunks is None:
        chunks = read_csv_records(os.path.join(
            config.paths.processed_dir, "drugs_word_chunks.csv"))
    if test_data is None:
        from persian_rag_tpu_torch.data.loader import synthetic_persian_qa

        test_data = synthetic_persian_qa(200, seed=13)

    evaluator = RAGEvaluator(
        llama_url=config.generation.server_url, llama_client=llama_client
    )
    performances: Dict[str, Dict] = {}
    results: Dict = {
        "evaluation_metadata": {
            "timestamp": datetime.datetime.now().isoformat(),
            "models_evaluated": config.models,
            "num_test_questions": min(sample_size or 0, len(test_data)),
            "chunk_types": ["word"],
            "enhancement": "per-model dense indices + rank metrics",
        }
    }
    for model_name in config.models:
        perf = evaluate_model(
            model_name, chunks, test_data, evaluator, config,
            mesh=mesh, tiny=tiny, sample_size=sample_size, device=device,
        )
        if perf:
            name = short_name(model_name)
            performances[name] = perf
            results[f"{name}_results"] = perf
    results["word_chunks_comparison"] = evaluator._analyze_model_comparison(
        performances
    )
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    evaluator.save_evaluation_results(
        results,
        f"phase4_enhanced_rag_evaluation_{stamp}.json",
        directory=config.paths.results_dir,
    )
    report = evaluator.create_evaluation_report(results)
    with open(
        os.path.join(
            config.paths.results_dir,
            f"phase4_enhanced_rag_report_{stamp}.md",
        ),
        "w",
        encoding="utf-8",
    ) as f:
        f.write(report)
    return results
