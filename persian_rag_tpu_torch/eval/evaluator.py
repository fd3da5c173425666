"""End-to-end RAG evaluation, model comparison and reports.

The counterpart of ``persian_rag_tpu.eval.evaluator``: per item retrieve
-> generate -> score with the whole metric suite, failure accounting
(failed retrievals and generations, success rate, empty answers scored),
per-model results under ``{model}_{metric}`` keys in the JAX package's
order, best-model / ranking / statistics tables, JSON that takes numpy
values, and the markdown report.

Retrieval runs in batches on the retriever's device, and the semantic
metrics take one encoder batch for the whole set. One chosen divergence:
an exception from ``retriever.retrieve_batch`` propagates, where the JAX
package turns the batch into empty results counted as failed retrievals
(on the card that would hide a failed kernel launch behind a metric). An
empty result list still counts as a failed retrieval. A ``None`` answer
from the HTTP client counts as a failed generation, as in the JAX
package.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from persian_rag_tpu_torch.eval.metrics import TextMetrics
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.retrieval.system import assemble_contexts

COMPARISON_METRICS = [
    "exact_match", "f1_score", "precision", "recall",
    "bleu_score", "rouge_l", "semantic_similarity",
    "answer_relevancy", "success_rate", "total_time",
]


class RAGEvaluator:
    def __init__(
        self,
        llama_url: str = "http://127.0.0.1:8080",
        llama_client: Optional[LlamaClient] = None,
    ):
        self.llama_client = llama_client or LlamaClient(llama_url)
        self.metrics = TextMetrics()

    # -- single-system evaluation ------------------------------------------------

    def evaluate_single_rag(
        self,
        retriever,
        test_data: List[Dict],
        model_name: str = "model",
        sample_size: Optional[int] = None,
        top_k: int = 5,
        eval_encoder=None,
        retrieval_batch_size: int = 32,
    ) -> Dict[str, Any]:
        if sample_size and len(test_data) > sample_size:
            test_data = test_data[:sample_size]
        n = len(test_data)
        if eval_encoder is None:
            eval_encoder = getattr(retriever, "embedding_model", None)

        questions = [item["question"] for item in test_data]
        golds = [item["answer"] for item in test_data]

        # Stage 1: batched retrieval (+ per-item context assembly). A
        # retrieval that raises stops the evaluation.
        contexts_per_item: List[List[str]] = []
        retrieval_times: List[float] = []
        failed_retrievals = 0
        for start in range(0, n, retrieval_batch_size):
            batch = questions[start : start + retrieval_batch_size]
            t0 = time.time()
            results = retriever.retrieve_batch(batch, top_k)
            per_query = (time.time() - t0) / max(len(batch), 1)
            for res in results:
                retrieval_times.append(per_query)
                contexts, _ = _assemble_contexts(res)
                if not contexts:
                    failed_retrievals += 1
                contexts_per_item.append(contexts)

        # Stage 2: generation through the HTTP client.
        preds: List[str] = []
        generation_times: List[float] = []
        failed_generations = 0
        for question, contexts in zip(questions, contexts_per_item):
            if not contexts:
                preds.append("")
                generation_times.append(0.0)
                continue
            t0 = time.time()
            try:
                answer = self.llama_client.answer_question(question, contexts)
            except Exception:
                answer = None
            generation_times.append(time.time() - t0)
            if not answer or not answer.strip():
                failed_generations += 1
                answer = ""
            preds.append(answer)

        # Stage 3: string metrics (host) + batched semantic metrics (device).
        m = self.metrics
        ems = [m.exact_match(p, g) for p, g in zip(preds, golds)]
        f1s = [m.f1_score(p, g) for p, g in zip(preds, golds)]
        precisions = [m.precision(p, g) for p, g in zip(preds, golds)]
        recalls = [m.recall(p, g) for p, g in zip(preds, golds)]
        bleus = [m.bleu_score(p, g) for p, g in zip(preds, golds)]
        rouges = [m.rouge_l(p, g) for p, g in zip(preds, golds)]
        rouge1s = [m.rouge_1(p, g) for p, g in zip(preds, golds)]
        # Context P/R: Jaccard-matched against the item's gold context when
        # it has one; otherwise 1.0 for any retrieved context.
        ctx_precisions, ctx_recalls = [], []
        for item, contexts in zip(test_data, contexts_per_item):
            gold_ctx = str(item.get("context") or "").strip()
            if gold_ctx and contexts:
                ctx_precisions.append(m.context_precision(contexts, [gold_ctx]))
                ctx_recalls.append(m.context_recall(contexts, [gold_ctx]))
            else:
                ctx_precisions.append(1.0 if contexts else 0.0)
                ctx_recalls.append(1.0 if contexts else 0.0)

        results: Dict[str, Any] = {
            f"{model_name}_exact_match": float(np.mean(ems)),
            f"{model_name}_f1_score": float(np.mean(f1s)),
            f"{model_name}_precision": float(np.mean(precisions)),
            f"{model_name}_recall": float(np.mean(recalls)),
            f"{model_name}_bleu_score": float(np.mean(bleus)),
            f"{model_name}_rouge_l": float(np.mean(rouges)),
            f"{model_name}_rouge_1": float(np.mean(rouge1s)),
            f"{model_name}_context_precision": float(np.mean(ctx_precisions)),
            f"{model_name}_context_recall": float(np.mean(ctx_recalls)),
            f"{model_name}_avg_retrieval_time": float(np.mean(retrieval_times)),
            f"{model_name}_avg_generation_time": float(np.mean(generation_times)),
            f"{model_name}_total_time": float(
                np.mean(retrieval_times) + np.mean(generation_times)
            ),
            f"{model_name}_failed_retrievals": failed_retrievals,
            f"{model_name}_failed_generations": failed_generations,
            f"{model_name}_success_rate": (
                (n - failed_retrievals - failed_generations) / n if n else 0.0
            ),
            f"{model_name}_num_samples": n,
        }

        if eval_encoder is not None:
            sem = m.semantic_similarity_batch(preds, golds, eval_encoder)
            rel = m.semantic_similarity_batch(preds, questions, eval_encoder)
            results[f"{model_name}_semantic_similarity"] = float(np.mean(sem))
            results[f"{model_name}_answer_relevancy"] = float(np.mean(rel))
        return results

    # -- comparison ---------------------------------------------------------------

    def _analyze_model_comparison(
        self, model_performances: Dict[str, Dict]
    ) -> Dict[str, Any]:
        """Best model, ranking and statistics per metric (total_time ranks
        ascending, every other metric descending)."""
        if not model_performances:
            return {}
        comparison: Dict[str, Any] = {
            "best_models": {},
            "ranking": {},
            "detailed_stats": {},
            "performance_summary": {},
        }
        for metric in COMPARISON_METRICS:
            scores = {
                name: results[f"{name}_{metric}"]
                for name, results in model_performances.items()
                if f"{name}_{metric}" in results
            }
            if not scores:
                continue
            ascending = metric == "total_time"
            ordered = sorted(
                scores.items(), key=lambda x: x[1], reverse=not ascending
            )
            comparison["best_models"][metric] = {
                "model": ordered[0][0],
                "score": ordered[0][1],
            }
            comparison["ranking"][metric] = [
                {"model": name, "score": score} for name, score in ordered
            ]
            values = list(scores.values())
            comparison["detailed_stats"][metric] = {
                "mean": float(np.mean(values)),
                "std": float(np.std(values)),
                "min": float(np.min(values)),
                "max": float(np.max(values)),
                "range": float(np.max(values) - np.min(values)),
            }
        comparison["performance_summary"] = {
            "total_models": len(model_performances),
            "metrics_evaluated": len(comparison["best_models"]),
        }
        return comparison

    # -- persistence ----------------------------------------------------------------

    def save_evaluation_results(
        self, results: Dict[str, Any], filename: str, directory: str = "results"
    ) -> str:
        os.makedirs(directory, exist_ok=True)
        filepath = os.path.join(directory, filename)
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(_to_jsonable(results), f, ensure_ascii=False, indent=2)
        return filepath

    def create_evaluation_report(self, results: Dict[str, Any]) -> str:
        report = "# Enhanced RAG Evaluation Report\n\n"
        if "evaluation_metadata" in results:
            md = results["evaluation_metadata"]
            report += "## Evaluation Metadata\n\n"
            report += f"- **Timestamp**: {md.get('timestamp', 'N/A')}\n"
            report += (
                f"- **Models Evaluated**: {len(md.get('models_evaluated', []))}\n"
            )
            report += (
                f"- **Test Questions**: {md.get('num_test_questions', 'N/A')}\n"
            )
            report += f"- **Chunk Types**: {', '.join(md.get('chunk_types', []))}\n"
            report += f"- **Enhancement**: {md.get('enhancement', 'N/A')}\n\n"
        for chunk_type in ("word", "sentence"):
            key = f"{chunk_type}_chunks_comparison"
            if key not in results:
                continue
            comparison = results[key]
            report += f"## Best Models for {chunk_type.title()} Chunks\n\n"
            for metric, info in comparison.get("best_models", {}).items():
                report += (
                    f"- **{metric.replace('_', ' ').title()}**: "
                    f"{info['model']} (Score: {info['score']:.4f})\n"
                )
            report += (
                f"\n### Detailed Rankings for {chunk_type.title()} Chunks\n\n"
            )
            for metric in ("f1_score", "bleu_score", "success_rate", "total_time"):
                ranking = comparison.get("ranking", {}).get(metric)
                if not ranking:
                    continue
                report += f"#### {metric.replace('_', ' ').title()}\n"
                for i, item in enumerate(ranking):
                    report += f"{i + 1}. {item['model']}: {item['score']:.4f}\n"
                report += "\n"
            stats = comparison.get("detailed_stats", {})
            if stats:
                report += (
                    f"### Performance Statistics for {chunk_type.title()} Chunks\n\n"
                )
                report += "| Metric | Mean | Std | Min | Max | Range |\n"
                report += "|--------|------|-----|-----|-----|-------|\n"
                for metric, s in stats.items():
                    if metric in ("f1_score", "bleu_score", "success_rate"):
                        report += (
                            f"| {metric.replace('_', ' ').title()} "
                            f"| {s['mean']:.4f} | {s['std']:.4f} "
                            f"| {s['min']:.4f} | {s['max']:.4f} "
                            f"| {s['range']:.4f} |\n"
                        )
                report += "\n"
        return report


def _assemble_contexts(results, top_k: int = 5, max_context_length: int = 2000):
    return assemble_contexts(results[:top_k], max_context_length)


def _to_jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj
