"""Phase 1 — data preparation + embedding fine-tuning.

The counterpart of ``persian_rag_tpu.pipelines.phase1``: build the QA
training records, split train / test, save ``train_data.csv`` and
``test_data.csv`` under ``paths.processed_dir`` (through the ``csv``
module), fine-tune each configured encoder on `device` (None: the card)
into ``<paths.models_dir>/<name>_finetuned`` and write
``<paths.results_dir>/phase1_training_results.json`` with the JAX
package's keys.

Chosen divergence: the records come from
`DataLoader.prepare_qa_data_for_training` without the hub datasets. The
JAX phase calls `load_datasets` first, which, offline, prints and returns
(None, None), so it trains on the same `synthetic_persian_qa()` records;
the port's `load_datasets` raises rather than download.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from persian_rag_tpu_torch.core.config import Config, ensure_directories
from persian_rag_tpu_torch.data.loader import DataLoader
from persian_rag_tpu_torch.pipelines.common import build_encoder, short_name
from persian_rag_tpu_torch.train.trainer import EmbeddingTrainer


def main(
    config: Optional[Config] = None,
    mesh=None,
    tiny: bool = False,
    max_records: Optional[int] = None,
    device=None,
) -> Dict:
    config = config or Config()
    ensure_directories(config)
    loader = DataLoader()

    qa_data = loader.prepare_qa_data_for_training()
    if max_records:
        qa_data = qa_data[:max_records]
    max_train = config.training.max_train_samples
    if max_train and len(qa_data) > max_train:
        qa_data = qa_data[:max_train]

    train_data, test_data = loader.create_test_split(
        qa_data, test_size=config.evaluation.test_size
    )
    loader.save_processed_data(
        train_data, "train_data.csv", config.paths.processed_dir
    )
    loader.save_processed_data(
        test_data, "test_data.csv", config.paths.processed_dir
    )

    results: Dict = {
        "total_qa_pairs": len(qa_data),
        "train_size": len(train_data),
        "test_size": len(test_data),
        "models": {},
    }
    for model_name in config.models:
        encoder = build_encoder(model_name, config, mesh=mesh, tiny=tiny,
                                device=device)
        trainer = EmbeddingTrainer(encoder)
        examples = trainer.prepare_training_data(train_data)
        eval_examples = trainer.prepare_evaluation_data(test_data)
        out_dir = os.path.join(
            config.paths.models_dir, short_name(model_name) + "_finetuned"
        )
        t0 = time.time()
        summary = trainer.fine_tune(
            examples,
            eval_examples=eval_examples,
            epochs=config.training.epochs,
            batch_size=config.training.batch_size,
            warmup_steps=config.training.warmup_steps,
            learning_rate=config.training.learning_rate,
            output_path=out_dir,
        )
        results["models"][model_name] = {
            "training_examples": len(examples),
            "training_time": time.time() - t0,
            "samples_per_second": summary["samples_per_second"],
            "final_loss": summary["final_loss"],
            "model_path": out_dir,
        }
        del encoder, trainer

    os.makedirs(config.paths.results_dir, exist_ok=True)
    out = os.path.join(
        config.paths.results_dir, "phase1_training_results.json"
    )
    with open(out, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    return results
