"""The port against the JAX package on real files, where they exist.

Skips unless one of these points at a local file:

* PERSIAN_RAG_ST_DIR — a sentence-transformers directory with its
  ``tokenizer.json`` (paraphrase-multilingual-MiniLM-L12-v2,
  distiluse-base-multilingual-cased-v2 or multilingual-e5-base): the
  port's HFTokenizer ids must equal the JAX package's and its
  ``SentenceEncoder.from_pretrained`` embeddings must be within 1e-5.
* PERSIAN_RAG_GGUF — a Llama-3 GGUF with embedded tokenizer metadata: the
  port's GGUFTokenizer ids and text must equal the JAX package's.

The tests decide inside themselves, so every worker collects the same
tests.
"""
import os

import numpy as np
import pytest

TEXTS = [
    "دارو برای درمان بیماری استفاده می‌شود",
    "مصرفِ دارو باید طبق دستور پزشک باشد؛ ۱۲ ساعت یک بار",
    "يك كتاب عربي و یک کتاب فارسی ١٢٣",
    "The patient's dose isn't 50mg — it's 5mg.\r\n  Next line\t😷",
    "",
]


def _env_path(name: str, want_dir: bool):
    path = os.environ.get(name, "")
    ok = os.path.isdir(path) if want_dir else os.path.isfile(path)
    if not (path and ok):
        pytest.skip(f"set {name} to a local "
                    f"{'directory' if want_dir else 'file'}")
    return path


def test_real_tokenizer_and_embeddings_match_jax():
    model_dir = _env_path("PERSIAN_RAG_ST_DIR", want_dir=True)
    if not os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        pytest.skip(f"{model_dir} has no tokenizer.json")
    from persian_rag_tpu.models.sentence_encoder import (
        SentenceEncoder as JaxSentenceEncoder,
    )
    from persian_rag_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer

    from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
    from persian_rag_tpu_torch.models.tokenizer import HFTokenizer

    got, want = HFTokenizer(model_dir), JaxHFTokenizer(model_dir)
    for a, b in zip(got.encode_batch(TEXTS, 128), want.encode_batch(TEXTS, 128)):
        np.testing.assert_array_equal(a, b)
    for text in TEXTS:
        assert got.encode(text) == want.encode(text)
        ids = want.encode(text)
        assert got.decode(ids) == want.decode(ids)
    enc = SentenceEncoder.from_pretrained(model_dir, device="cpu")
    jenc = JaxSentenceEncoder.from_pretrained(model_dir)
    np.testing.assert_allclose(enc.encode(TEXTS), jenc.encode(TEXTS),
                               atol=1e-5)


def test_real_gguf_tokenizer_matches_jax():
    path = _env_path("PERSIAN_RAG_GGUF", want_dir=False)
    from persian_rag_tpu.models import gguf as jgguf

    from persian_rag_tpu_torch.models import gguf as tgguf

    gf, jgf = tgguf.GGUFFile(path), jgguf.GGUFFile(path)
    try:
        got, want = tgguf.tokenizer_from_gguf(gf), jgguf.tokenizer_from_gguf(jgf)
        if want is None:
            pytest.skip(f"{path} embeds no tokenizer")
        assert (got.bos_id, got.eos_id, got.vocab_size) == (
            want.bos_id, want.eos_id, want.vocab_size)
        for text in TEXTS:
            ids = want.encode(text)
            assert got.encode(text) == ids
            assert got.decode(ids) == want.decode(ids)
    finally:
        gf.close()
        jgf.close()
