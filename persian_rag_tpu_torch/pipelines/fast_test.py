"""Fast smoke checks and the system status.

The counterpart of ``persian_rag_tpu.pipelines.fast_test``: three checks
that return a structured pass / fail result (retrieval alone, the LLM
server alone, the whole RAG loop), `show_system_status` (which processed
artifacts exist, what the generation server at
``generation.server_url`` answers) and `run_menu`, the interactive menu
read from `input()`. Retrieval lives on `device` (None: the card); the
chunk and test CSVs are read by `read_csv_records`.

One chosen divergence: `test_full_rag_pipeline` returns ``{"passed":
False, "error": "index build failed"}`` when the index cannot be built, as
`test_retrieval_only` does, where the JAX package ignores the failure and
raises from the unbuilt system.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.eval.metrics import TextMetrics
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.retrieval.system import (
    RetrievalSystem,
    read_csv_records,
)

SMOKE_QUERIES = [
    "دارو چیست؟",
    "عوارض جانبی دارو کدامند؟",
    "نحوه مصرف دارو چگونه است؟",
    "موارد منع مصرف چیست؟",
    "تداخل دارویی یعنی چه؟",
]

LLM_PROMPTS = [
    "سلام، حالت چطور است؟",
    "دارو چیست؟",
    "یک جمله درباره سلامتی بنویس",
]


def test_retrieval_only(
    chunks: List[Dict], method: str = "bm25", encoder=None, device=None
) -> Dict:
    retriever = RetrievalSystem(method=method, encoder=encoder, device=device)
    if not retriever.load_chunks_and_index(chunks):
        return {"passed": False, "error": "index build failed"}
    timings = []
    hits = 0
    for query in SMOKE_QUERIES:
        t0 = time.time()
        results = retriever.retrieve(query, top_k=3)
        timings.append(time.time() - t0)
        if results:
            hits += 1
    return {
        "passed": hits == len(SMOKE_QUERIES),
        "queries": len(SMOKE_QUERIES),
        "with_results": hits,
        "avg_time": sum(timings) / len(timings),
    }


def test_llama_only(client: LlamaClient) -> Dict:
    if not client.connected:
        return {"passed": False, "error": "server unreachable"}
    answered = 0
    for prompt in LLM_PROMPTS:
        if client.generate(prompt, max_tokens=64):
            answered += 1
    return {"passed": answered > 0, "answered": answered, "total": len(LLM_PROMPTS)}


def test_full_rag_pipeline(
    chunks: List[Dict],
    test_items: List[Dict],
    client: LlamaClient,
    method: str = "bm25",
    encoder=None,
    device=None,
) -> Dict:
    retriever = RetrievalSystem(method=method, encoder=encoder, device=device)
    if not retriever.load_chunks_and_index(chunks):
        return {"passed": False, "error": "index build failed"}
    metrics = TextMetrics()
    per_question = []
    for item in test_items[:3]:
        contexts, _ = retriever.get_contexts_for_rag(item["question"], top_k=3)
        answer = client.answer_question(item["question"], contexts) or ""
        per_question.append(
            {
                "question": item["question"],
                "answer": answer,
                "f1": metrics.f1_score(answer, item["answer"]),
                "bleu": metrics.bleu_score(answer, item["answer"]),
            }
        )
    return {
        "passed": any(q["answer"] for q in per_question),
        "questions": per_question,
    }


def show_system_status(config: Optional[Config] = None) -> Dict:
    config = config or Config()
    processed = config.paths.processed_dir
    artifacts = {
        name: os.path.exists(os.path.join(processed, name))
        for name in (
            "train_data.csv",
            "test_data.csv",
            "drugs_word_chunks.csv",
            "drugs_sentence_chunks.csv",
        )
    }
    client = LlamaClient(config.generation.server_url)
    return {
        "artifacts": artifacts,
        "server": client.get_server_info(),
    }


def run_menu(config: Optional[Config] = None, device=None) -> None:
    """The interactive menu: 1 retrieval alone, 2 the LLM alone, 3 the
    whole pipeline, 4 status, q quit."""
    config = config or Config()
    chunk_csv = os.path.join(
        config.paths.processed_dir, "drugs_word_chunks.csv"
    )
    print("1) retrieval-only  2) LLM-only  3) full pipeline  4) status  q) quit")
    while True:
        choice = input("> ").strip()
        if choice == "q":
            break
        if choice == "1":
            chunks = read_csv_records(chunk_csv)
            print(test_retrieval_only(chunks, device=device))
        elif choice == "2":
            print(test_llama_only(LlamaClient(config.generation.server_url)))
        elif choice == "3":
            chunks = read_csv_records(chunk_csv)
            test_csv = os.path.join(config.paths.processed_dir, "test_data.csv")
            items = read_csv_records(test_csv)
            print(
                test_full_rag_pipeline(
                    chunks, items, LlamaClient(config.generation.server_url),
                    device=device,
                )
            )
        elif choice == "4":
            print(show_system_status(config))
