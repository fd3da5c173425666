"""Host-side tokenization feeding fixed-shape padded batches.

A JAX-free copy of ``persian_rag_tpu.models.tokenizer``: the JAX package's
module is itself free of JAX, but importing it runs the JAX package's
``__init__`` files, which load jax and flax. The ids are identical to the
JAX copy's (tests/test_torch_encoder.py holds them against it).

Sequence lengths round up to a small set of buckets, so padded batches
come in few shapes. HashTokenizer is a deterministic hashing tokenizer
(whitespace words -> stable ids), so the pipeline runs without a
vocabulary file.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (16, 32, 64, 128, 256)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TokenizerBase:
    pad_id: int = 0

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 256
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask), both (B, L) with L bucketed."""
        raise NotImplementedError


class HashTokenizer(TokenizerBase):
    """Deterministic word-hash tokenizer: pad=0, cls=1, sep=2, unk=3."""

    pad_id = 0
    cls_id = 1
    sep_id = 2

    def __init__(self, vocab_size: int = 250002, add_special: bool = True):
        self.vocab_size = vocab_size
        self.add_special = add_special
        self._n_special = 4

    def _word_id(self, word: str) -> int:
        digest = hashlib.md5(word.encode("utf-8")).digest()
        value = int.from_bytes(digest[:8], "little")
        return self._n_special + value % (self.vocab_size - self._n_special)

    def encode(self, text: str, max_len: int = 256) -> List[int]:
        words = text.split()
        budget = max_len - (2 if self.add_special else 0)
        ids = [self._word_id(w) for w in words[:budget]]
        if self.add_special:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 256
    ) -> Tuple[np.ndarray, np.ndarray]:
        encoded = [self.encode(t, max_len) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        length = bucket_length(min(longest, max_len))
        ids = np.full((len(texts), length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, e in enumerate(encoded):
            e = e[:length]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

