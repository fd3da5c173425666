"""Phase 2 — embedding-model retrieval evaluation.

The counterpart of ``persian_rag_tpu.pipelines.phase2``: for each
configured model, multiple choice — a question against its correct answer
and 4 distractor answers, cosine argmax; accuracy is the share where the
correct answer ranks first. Only the measured metrics are reported
(retrieval_accuracy, cosine_similarity); the reference's simulated EM /
F1 are left out, as in the JAX package. The encoders live on `device`
(None: the card); the test items come from
``<paths.processed_dir>/test_data.csv`` (`read_csv_records`) or, without
it, from `synthetic_persian_qa(500, seed=9)`.
"""
from __future__ import annotations

import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.pipelines.common import build_encoder
from persian_rag_tpu_torch.retrieval.system import read_csv_records


def evaluate_model_performance(
    encoder,
    test_data: List[Dict],
    sample_size: int = 100,
    n_distractors: int = 4,
    seed: int = 42,
) -> Dict:
    """Question -> [correct answer + distractors], cosine argmax accuracy,
    with one encoder call for the questions and one for every candidate."""
    rng = random.Random(seed)
    pool = [item["answer"] for item in test_data]
    items = test_data[:sample_size]
    questions = [item["question"] for item in items]

    candidate_lists: List[List[str]] = []
    for item in items:
        # distractors capped by the distinct answers available, padded with
        # non-matching strings so that candidate lists stay rectangular
        available = sorted(set(pool) - {item["answer"]})
        take = min(n_distractors, len(available))
        distractors = rng.sample(available, take)
        while len(distractors) < n_distractors:
            distractors.append(f"گزینه نامربوط {len(distractors)}")
        candidate_lists.append([item["answer"]] + distractors)

    t0 = time.time()
    q_emb = encoder.encode(questions)
    flat_answers = [a for cands in candidate_lists for a in cands]
    a_emb = encoder.encode(flat_answers)
    elapsed = time.time() - t0

    n_cands = n_distractors + 1
    correct = 0
    gold_sims = []
    for i in range(len(items)):
        cands = a_emb[i * n_cands : (i + 1) * n_cands]
        q = q_emb[i]
        denom = np.maximum(
            np.linalg.norm(cands, axis=1) * np.linalg.norm(q), 1e-12
        )
        sims = cands @ q / denom
        gold_sims.append(float(sims[0]))
        if int(np.argmax(sims)) == 0:
            correct += 1

    return {
        "retrieval_accuracy": correct / max(len(items), 1),
        "cosine_similarity": float(np.mean(gold_sims)) if gold_sims else 0.0,
        "evaluation_time": elapsed,
        "num_samples": len(items),
    }


def compare_models(model_results: Dict[str, Dict]) -> Dict:
    comparison: Dict = {"rankings": {}, "best_model": {}}
    for metric in ("retrieval_accuracy", "cosine_similarity"):
        scores = {
            name: res[metric]
            for name, res in model_results.items()
            if metric in res
        }
        if not scores:
            continue
        ordered = sorted(scores.items(), key=lambda x: x[1], reverse=True)
        comparison["rankings"][metric] = [
            {"model": n, "score": s} for n, s in ordered
        ]
        comparison["best_model"][metric] = ordered[0][0]
    return comparison


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    test_data: Optional[List[Dict]] = None,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)

    if test_data is None:
        test_csv = os.path.join(config.paths.processed_dir, "test_data.csv")
        if os.path.exists(test_csv):
            test_data = read_csv_records(test_csv)
        else:
            from persian_rag_tpu_torch.data.loader import synthetic_persian_qa

            test_data = synthetic_persian_qa(500, seed=9)
    test_data = test_data[:500]
    sample = min(config.evaluation.sample_size or 100, 100)

    model_results: Dict[str, Dict] = {}
    for model_name in config.models:
        encoder = build_encoder(model_name, config, mesh=mesh, tiny=tiny,
                                device=device)
        model_results[model_name] = evaluate_model_performance(
            encoder, test_data, sample_size=sample
        )
        del encoder

    comparison = compare_models(model_results)
    results = {"models": model_results, "comparison": comparison}
    with open(
        os.path.join(config.paths.results_dir, "phase2_evaluation_results.json"),
        "w",
        encoding="utf-8",
    ) as f:
        json.dump(model_results, f, ensure_ascii=False, indent=2)
    with open(
        os.path.join(config.paths.results_dir, "phase2_model_comparison.json"),
        "w",
        encoding="utf-8",
    ) as f:
        json.dump(comparison, f, ensure_ascii=False, indent=2)
    return results
