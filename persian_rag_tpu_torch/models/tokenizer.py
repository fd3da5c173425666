"""Host-side tokenization feeding fixed-shape padded batches.

A JAX-free copy of ``persian_rag_tpu.models.tokenizer``: the JAX package's
module is itself free of JAX, but importing it runs the JAX package's
``__init__`` files, which load jax and flax. The ids are identical to the
JAX copy's (tests/test_torch_encoder.py holds them against it).

Sequence lengths round up to a small set of buckets, so padded batches
come in few shapes. HashTokenizer is a deterministic hashing tokenizer
(whitespace words -> stable ids), so the pipeline runs without a
vocabulary file. HFTokenizer reads a local HuggingFace ``tokenizer.json``
through `models/tokenizer_json.py` (no ``tokenizers`` library needed).
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

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



class HFTokenizer(TokenizerBase):
    """A local HuggingFace ``tokenizer.json`` (a file, or a directory that
    holds one), with the JAX package's HFTokenizer rules: `encode` for
    generation (no post-processor specials, BOS prepended when the
    vocabulary has one), `decode` skipping special tokens, and
    `encode_batch` (specials added, sequences sliced to max_len, the
    length bucketed). Unlike the JAX package, a directory without
    ``tokenizer.json`` raises: the ``transformers`` fallback it would take
    needs a library that the serving machine does not have."""

    def __init__(self, path: str, pad_id: Optional[int] = None):
        from persian_rag_tpu_torch.models.tokenizer_json import TokenizerJSON

        tok_json = (
            path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
        )
        if not os.path.exists(tok_json):
            raise FileNotFoundError(
                f"{tok_json} not found: HFTokenizer needs the model's "
                "tokenizer.json (a sentencepiece- or vocab.txt-only "
                "directory: save it once with a fast tokenizer to write one)")
        self._tok = TokenizerJSON.from_file(tok_json)
        self.path = tok_json  # a fine-tuned model's save_model copies it
        pad_token_id = self._tok.token_to_id("<pad>")
        if pad_token_id is None:
            pad_token_id = self._tok.token_to_id("[PAD]") or 0
        self.pad_id = pad_id if pad_id is not None else pad_token_id
        self.bos_id = self._first_id("<|begin_of_text|>", "<s>", "<bos>", "[CLS]")
        self.eos_id = self._first_id(
            "<|eot_id|>", "<|end_of_text|>", "</s>", "<eos>", "[SEP]")
        self.vocab_size = self._tok.get_vocab_size()

    def _first_id(self, *candidates: str) -> int:
        for token in candidates:
            tid = self._tok.token_to_id(token)
            if tid is not None:
                return tid
        return -1  # "never matches": the decode loop compares token != eos

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Generation-side single-text encode (BOS prepended when the
        vocabulary has one)."""
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        return list(ids)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 256
    ) -> Tuple[np.ndarray, np.ndarray]:
        seqs = [e[:max_len] for e in self._tok.encode_batch(list(texts))]
        longest = max((len(s) for s in seqs), default=1)
        length = bucket_length(min(longest, max_len))
        ids = np.full((len(texts), length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, s in enumerate(seqs):
            s = s[:length]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return ids, mask
