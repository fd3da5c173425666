"""Generation and retrieval quality metrics.

The counterpart of ``persian_rag_tpu.eval.metrics``, operation for
operation, so that every string metric equals the JAX package's bit for
bit:

* text cleaning: lowercase, Persian -> ASCII digit folding, punctuation
  stripped (the Persian block kept), whitespace collapsed;
* tokenization: whitespace, length > 1, 11 Persian stopwords removed;
* EM, token-set F1 / precision / recall;
* BLEU-n: orders up to min(n, len(pred_tokens)), the geometric mean of
  the clipped n-gram precisions (a zero precision gives log -inf and so a
  zero score), the brevity penalty, capped at 1.0;
* ROUGE-1 (unigram overlap F1) and ROUGE-L (LCS F1);
* context precision / recall by token Jaccard >= 0.7;
* hit@k, MRR@k and recall@k over id lists.

`semantic_similarity_batch` encodes predictions and golds as one batch
with the port's `SentenceEncoder` on its device and takes the pairwise
cosines there; one host copy brings them back.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PERSIAN_STOPWORDS = {
    "در", "از", "به", "با", "که", "را", "و", "تا", "بر", "این", "آن",
}

_DIGIT_RE = re.compile(r"[۰-۹]")
_PUNCT_RE = re.compile(r"[^\w\s؀-ۿ]")
_WS_RE = re.compile(r"\s+")


class TextMetrics:
    """Stateless string metrics."""

    # -- text plumbing -------------------------------------------------------

    def clean_text(self, text: str) -> str:
        if not text:
            return ""
        text = text.strip().lower()
        text = _DIGIT_RE.sub(lambda m: str(ord(m.group()) - ord("۰")), text)
        text = _PUNCT_RE.sub("", text)
        text = _WS_RE.sub(" ", text)
        return text.strip()

    def tokenize(self, text: str) -> List[str]:
        clean = self.clean_text(text)
        if not clean:
            return []
        return [
            t
            for t in clean.split()
            if len(t) > 1 and t not in PERSIAN_STOPWORDS
        ]

    @staticmethod
    def ngrams(tokens: Sequence[str], n: int) -> Dict[Tuple[str, ...], int]:
        counts: Counter = Counter()
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
        return dict(counts)

    @staticmethod
    def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
        """Longest common subsequence by a rolling 1-D DP row."""
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            curr = [0]
            for j, y in enumerate(b, 1):
                if x == y:
                    curr.append(prev[j - 1] + 1)
                else:
                    curr.append(max(prev[j], curr[j - 1]))
            prev = curr
        return prev[-1]

    # -- string metrics ------------------------------------------------------

    def exact_match(self, pred: str, gold: str) -> float:
        return float(self.clean_text(pred) == self.clean_text(gold))

    def _token_sets(self, pred: str, gold: str):
        return set(self.tokenize(pred)), set(self.tokenize(gold))

    def f1_score(self, pred: str, gold: str) -> float:
        p, g = self._token_sets(pred, gold)
        if not p and not g:
            return 1.0
        if not p or not g:
            return 0.0
        common = p & g
        precision = len(common) / len(p)
        recall = len(common) / len(g)
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)

    def precision(self, pred: str, gold: str) -> float:
        p, g = self._token_sets(pred, gold)
        if not p:
            return 0.0
        return len(p & g) / len(p)

    def recall(self, pred: str, gold: str) -> float:
        p, g = self._token_sets(pred, gold)
        if not g:
            return 0.0
        return len(p & g) / len(g)

    def bleu_score(self, pred: str, gold: str, n: int = 4) -> float:
        pred_tokens = self.tokenize(pred)
        gold_tokens = self.tokenize(gold)
        if not pred_tokens or not gold_tokens:
            return 0.0
        scores: List[float] = []
        for order in range(1, min(n + 1, len(pred_tokens) + 1)):
            pred_ngrams = self.ngrams(pred_tokens, order)
            gold_ngrams = self.ngrams(gold_tokens, order)
            if not pred_ngrams:
                scores.append(0.0)
                continue
            matches = sum(
                min(count, gold_ngrams[ng])
                for ng, count in pred_ngrams.items()
                if ng in gold_ngrams
            )
            scores.append(matches / sum(pred_ngrams.values()))
        if not scores or all(s == 0 for s in scores):
            return 0.0
        log_mean = np.mean(
            [math.log(s) if s > 0 else -float("inf") for s in scores]
        )
        bleu = float(np.exp(log_mean))
        brevity = 1.0
        if len(pred_tokens) < len(gold_tokens):
            brevity = math.exp(1 - len(gold_tokens) / len(pred_tokens))
        return min(bleu * brevity, 1.0)

    def rouge_1(self, pred: str, gold: str) -> float:
        """Unigram-overlap F1."""
        pred_counts = Counter(self.tokenize(pred))
        gold_counts = Counter(self.tokenize(gold))
        if not pred_counts or not gold_counts:
            return 0.0
        overlap = sum(
            min(count, gold_counts[t]) for t, count in pred_counts.items()
        )
        precision = overlap / sum(pred_counts.values())
        recall = overlap / sum(gold_counts.values())
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)

    def rouge_l(self, pred: str, gold: str) -> float:
        pred_tokens = self.tokenize(pred)
        gold_tokens = self.tokenize(gold)
        if not pred_tokens or not gold_tokens:
            return 0.0
        lcs = self.lcs_length(pred_tokens, gold_tokens)
        if lcs == 0:
            return 0.0
        precision = lcs / len(pred_tokens)
        recall = lcs / len(gold_tokens)
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)

    # -- context metrics -----------------------------------------------------

    def is_similar_context(
        self, ctx1: str, ctx2: str, threshold: float = 0.7
    ) -> bool:
        t1, t2 = set(self.tokenize(ctx1)), set(self.tokenize(ctx2))
        if not t1 or not t2:
            return False
        union = t1 | t2
        return (len(t1 & t2) / len(union) if union else 0.0) >= threshold

    def context_precision(
        self, retrieved: List[str], relevant: List[str]
    ) -> float:
        if not retrieved:
            return 0.0
        hits = sum(
            1
            for ctx in retrieved
            if any(self.is_similar_context(ctx, rel) for rel in relevant)
        )
        return hits / len(retrieved)

    def context_recall(
        self, retrieved: List[str], relevant: List[str]
    ) -> float:
        if not relevant:
            return 1.0
        hits = sum(
            1
            for rel in relevant
            if any(self.is_similar_context(ctx, rel) for ctx in retrieved)
        )
        return hits / len(relevant)

    # -- semantic metrics (on the encoder's device) ---------------------------

    def semantic_similarity(
        self, pred: str, gold: str, encoder
    ) -> float:
        if not pred.strip() or not gold.strip():
            return 0.0
        sims = self.semantic_similarity_batch([pred], [gold], encoder)
        return float(sims[0])

    @torch.inference_mode()
    def semantic_similarity_batch(
        self, preds: Sequence[str], golds: Sequence[str], encoder
    ) -> np.ndarray:
        """Pairwise cosine(pred_i, gold_i) clipped to [0, 1] (0 where
        either text is blank): one encoder batch of preds + golds and the
        cosines on the encoder's device, one host copy."""
        assert len(preds) == len(golds)
        if not preds:
            return np.zeros(0, np.float32)
        emb = encoder.encode_device(list(preds) + list(golds)).float()
        a, b = emb[: len(preds)], emb[len(preds):]
        denom = torch.clamp(a.norm(dim=1) * b.norm(dim=1), min=1e-12)
        sims = (a * b).sum(1) / denom
        empty = torch.tensor(
            [not p.strip() or not g.strip() for p, g in zip(preds, golds)],
            device=sims.device,
        )
        sims = torch.where(empty, torch.zeros_like(sims), sims)
        return sims.clamp(0.0, 1.0).cpu().numpy()

    def answer_relevancy(self, answer: str, question: str, encoder) -> float:
        return self.semantic_similarity(answer, question, encoder)


# -- retrieval-rank metrics ----------------------------------------------------


def hit_at_k(retrieved_ids: Sequence, relevant: Sequence, k: int) -> float:
    return float(any(r in relevant for r in list(retrieved_ids)[:k]))


def mrr_at_k(retrieved_ids: Sequence, relevant: Sequence, k: int = 10) -> float:
    for rank, rid in enumerate(list(retrieved_ids)[:k], 1):
        if rid in relevant:
            return 1.0 / rank
    return 0.0


def recall_at_k(
    retrieved_ids: Sequence, relevant: Sequence, k: int
) -> float:
    if not relevant:
        return 0.0
    got = sum(1 for r in list(retrieved_ids)[:k] if r in relevant)
    return got / len(relevant)
