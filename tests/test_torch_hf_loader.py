"""The port's HF loader, SentenceEncoder.from_pretrained and
RetrievalSystem(model_path=) against the JAX package's, on the CPU.

Tiny random BERT, XLM-RoBERTa and DistilBERT models come from
``transformers`` (``save_pretrained``, safetensors and ``.bin``) in
sentence-transformers layouts (Pooling, Dense, Normalize), with a
``tokenizer.json`` trained by tests/test_torch_tokenizer_json.py's
builders. Trees must be equal array by array; embeddings within 1e-5.
"""
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from persian_rag_tpu.models import hf_loader as jax_loader  # noqa: E402
from persian_rag_tpu.models.sentence_encoder import (  # noqa: E402
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.retrieval.system import (  # noqa: E402
    RetrievalSystem as JaxRetrieval,
)

from persian_rag_tpu_torch.models import hf_loader  # noqa: E402
from persian_rag_tpu_torch.models.sentence_encoder import (  # noqa: E402
    SentenceEncoder,
)
from persian_rag_tpu_torch.models.tokenizer import (  # noqa: E402
    HashTokenizer,
    HFTokenizer,
)
from persian_rag_tpu_torch.retrieval.system import (  # noqa: E402
    RetrievalSystem,
)
from test_torch_tokenizer_json import (  # noqa: E402
    TEXTS,
    _unigram,
    _wordpiece,
)

ATOL = 1e-5

# (name, transformers model + config, pooling, dense out, normalize,
#  weights format, tokenizer builder)
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=160)
ARCHS = {
    "bert_mean": ("bert", "mean", None, False, "safetensors",
                  lambda p: _wordpiece(p, False)),
    "xlmr_normalize": ("xlm-roberta", "mean", None, True, "bin",
                       lambda p: _unigram(p, False)),
    "distilbert_dense": ("distilbert", "mean", 16, False, "safetensors",
                         lambda p: _wordpiece(p, True)),
    "bert_cls_dense_bin": ("bert", "cls", 24, True, "bin",
                           lambda p: _wordpiece(p, False)),
}


def _hf_model(kind, vocab):
    torch.manual_seed(0)
    if kind == "bert":
        cfg = transformers.BertConfig(vocab_size=vocab, **SMALL)
        return transformers.BertModel(cfg)
    if kind == "xlm-roberta":
        cfg = transformers.XLMRobertaConfig(vocab_size=vocab, pad_token_id=1,
                                            **SMALL)
        return transformers.XLMRobertaModel(cfg)
    cfg = transformers.DistilBertConfig(
        vocab_size=vocab, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
        max_position_embeddings=160)
    return transformers.DistilBertModel(cfg)


def _write_st_dir(root, name):
    kind, pooling, dense, normalize, fmt, build_tok = ARCHS[name]
    path = os.path.join(root, name)
    os.makedirs(path)
    build_tok(os.path.join(path, "tokenizer.json"))
    vocab = HFTokenizer(path).vocab_size
    model = _hf_model(kind, vocab).eval()
    model.save_pretrained(path, safe_serialization=(fmt == "safetensors"))
    modules = [{"idx": 0, "name": "0", "path": "",
                "type": "sentence_transformers.models.Transformer"}]
    os.makedirs(os.path.join(path, "1_Pooling"))
    with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
        json.dump({"word_embedding_dimension": 32,
                   "pooling_mode_cls_token": pooling == "cls",
                   "pooling_mode_mean_tokens": pooling == "mean"}, f)
    modules.append({"idx": 1, "name": "1", "path": "1_Pooling",
                    "type": "sentence_transformers.models.Pooling"})
    if dense:
        dpath = os.path.join(path, "2_Dense")
        os.makedirs(dpath)
        with open(os.path.join(dpath, "config.json"), "w") as f:
            json.dump({"in_features": 32, "out_features": dense,
                       "bias": True}, f)
        gen = torch.Generator().manual_seed(1)
        sd = {"linear.weight": torch.randn(dense, 32, generator=gen) * 0.2,
              "linear.bias": torch.randn(dense, generator=gen) * 0.1}
        if fmt == "safetensors":
            safetensors_torch.save_file(
                sd, os.path.join(dpath, "model.safetensors"))
        else:
            torch.save(sd, os.path.join(dpath, "pytorch_model.bin"))
        modules.append({"idx": 2, "name": "2", "path": "2_Dense",
                        "type": "sentence_transformers.models.Dense"})
    if normalize:
        modules.append({"idx": 3, "name": "3", "path": "3_Normalize",
                        "type": "sentence_transformers.models.Normalize"})
    with open(os.path.join(path, "modules.json"), "w") as f:
        json.dump(modules, f)
    return path


@pytest.fixture(scope="module")
def st_dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("st"))
    return {name: _write_st_dir(root, name) for name in ARCHS}


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
    elif want is None or isinstance(want, (str, bool, int)):
        assert got == want, path
    else:
        assert got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_load_sentence_transformer_equals_jax(st_dirs, name):
    got = hf_loader.load_sentence_transformer(st_dirs[name])
    want = jax_loader.load_sentence_transformer(st_dirs[name])
    # the encoder configs (the JAX one also holds compute_dtype and remat)
    assert got[0].__dict__ == {k: want[0].__dict__[k] for k in got[0].__dict__}
    _assert_trees_equal(got[1], want[1])
    _assert_trees_equal(got[2], want[2])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_from_pretrained_embeddings_match_jax(st_dirs, name):
    enc = SentenceEncoder.from_pretrained(st_dirs[name], device="cpu")
    jenc = JaxSentenceEncoder.from_pretrained(st_dirs[name])
    assert isinstance(enc.tokenizer, HFTokenizer)
    assert enc.dim == jenc.dim
    np.testing.assert_allclose(enc.encode(TEXTS, batch_size=8),
                               jenc.encode(TEXTS, batch_size=8), atol=ATOL)
    assert abs(enc.similarity(TEXTS[1], TEXTS[2])
               - jenc.similarity(TEXTS[1], TEXTS[2])) < ATOL


def test_retrieval_system_model_path_matches_jax(st_dirs):
    chunks = [{"id": f"c{i}", "text": t} for i, t in enumerate(TEXTS) if t]
    rs = RetrievalSystem(method="dense", model_path=st_dirs["bert_mean"],
                         device="cpu")
    jrs = JaxRetrieval(method="dense", model_path=st_dirs["bert_mean"])
    assert rs.load_chunks_and_index(chunks) and jrs.load_chunks_and_index(
        chunks)
    for query in ("دارو و درمان", "کتاب پزشکی", "they're here"):
        got, want = rs.retrieve(query, 4), jrs.retrieve(query, 4)
        assert [c["id"] for c, _ in got] == [c["id"] for c, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-4)


def test_no_tokenizer_json_keeps_hash_tokenizer(st_dirs, tmp_path, caplog):
    src = st_dirs["bert_mean"]
    for name in ("config.json", "model.safetensors"):
        with open(os.path.join(src, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    enc = SentenceEncoder.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(enc.tokenizer, HashTokenizer)
    assert "no tokenizer.json" in caplog.text


def test_bad_tokenizer_json_raises(st_dirs, tmp_path):
    src = st_dirs["bert_mean"]
    for name in ("config.json", "model.safetensors"):
        with open(os.path.join(src, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    (tmp_path / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "WordLevel", "vocab": {}}}))
    with pytest.raises(NotImplementedError, match="WordLevel"):
        SentenceEncoder.from_pretrained(str(tmp_path), device="cpu")


def test_read_safetensors_dtypes(tmp_path):
    gen = torch.Generator().manual_seed(0)
    sd = {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(4, generator=gen).half(),
        "bf16": torch.randn(2, 3, generator=gen).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(7, dtype=torch.int32),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "model.safetensors")
    safetensors_torch.save_file(sd, path, metadata={"format": "pt"})
    got = hf_loader.read_safetensors(path)
    want = safetensors_torch.load_file(path)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    assert set(hf_loader._read_state_dict(str(tmp_path))) == set(sd)
    with pytest.raises(FileNotFoundError):
        hf_loader._read_state_dict(str(tmp_path / "missing"))
