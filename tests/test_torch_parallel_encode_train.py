"""Data parallelism of the port against the JAX package, on the CPU:
`SentenceEncoder(mesh=)` encoding, `EmbeddingTrainer` steps and
`LoraTrainer` steps over the mesh's data axis.

The JAX side runs on conftest's 8 virtual CPU devices (its jit shards the
batch over ``data``); the port's mesh repeats the CPU device. Tolerances:
`encode` within 1e-5 of the port's single-device encoder and within the
cross-framework 1e-4 of tests/test_torch_train_trainer.py (EMB_ATOL) of
the JAX one; a step's loss within 1e-6 relative, gradients within 1e-5 of
the largest, parameters after AdamW steps within 1e-5 (the limits of
tests/test_torch_train_trainer.py); LoRA `fit` losses within 1e-4 and
merged trees within 1e-5, as tests/test_torch_train_lora.py holds the
single-device trainer.
"""
import jax
import numpy as np
import pytest
import torch

from persian_rag_tpu.core.mesh import build_mesh as jbuild
from persian_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHash
from persian_rag_tpu.train import lora as jl
from persian_rag_tpu.train.trainer import EmbeddingTrainer as JaxTrainer
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.train import EmbeddingTrainer, InputExample
from persian_rag_tpu_torch.train import lora as tl

from test_torch_train_lora import QA, _assert_trees, _setup
from test_torch_train_trainer import (
    EMB_ATOL,
    LR,
    SMALL,
    _capture,
    _flat,
    _np_tree,
    _port_tree,
    _records,
)

TEXTS = [f"متن شماره {i} درباره دارو و درمان" for i in range(13)]


def _meshes(corpus, data):
    return (jbuild(corpus, data, devices=jax.devices()[:corpus * data]),
            build_mesh(corpus, data, devices=["cpu"] * (corpus * data)))


def _pair(jmesh=None, tmesh=None, seed=3, proj=16):
    jenc = JaxEncoder(JaxConfig(**SMALL, type_vocab_size=0),
                      projection_dim=proj, tokenizer=JaxHash(512),
                      max_seq_len=32, seed=seed, mesh=jmesh)
    tree = _np_tree(jenc.params)
    kw = dict(device="cpu") if tmesh is None else dict(mesh=tmesh)
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL, type_vocab_size=0),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        projection_dim=proj,
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(512), max_seq_len=32, **kw)
    return jenc, tenc


@pytest.mark.parametrize("corpus,data", [(4, 2), (1, 8), (2, 3)])
def test_data_parallel_encode_equals_jax_and_single(corpus, data):
    jm, tm = _meshes(corpus, data)
    jenc, tenc = _pair(jm, tm)
    _, one = _pair()
    assert tenc.data_parallel == data
    # 13 texts: a last batch that the data axis does not divide
    got = tenc.encode(TEXTS, batch_size=5)
    np.testing.assert_allclose(got, one.encode(TEXTS, batch_size=5),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jenc.encode(TEXTS, batch_size=5),
                               rtol=0, atol=EMB_ATOL)
    dev = tenc.encode_device(TEXTS[:3])
    assert dev.shape == (3, 16) and dev.device == torch.device("cpu")
    np.testing.assert_allclose(dev.numpy(), got[:3], rtol=0, atol=1e-5)
    emb, stats = tenc.encode_robust(TEXTS[:5], batch_size=4)
    assert stats == {"failed": 0, "fallback_items": 0}
    np.testing.assert_allclose(emb, got[:5], rtol=0, atol=1e-5)


def _batch():
    jenc, _ = _pair()
    examples = JaxTrainer(jenc, seed=3).prepare_training_data(_records())
    return [InputExample(list(e.texts), e.label) for e in examples]


def test_data_parallel_step_loss_and_gradients_equal_jax():
    jm, tm = _meshes(4, 2)
    jenc, tenc = _pair(jm, tm)
    jt, tt = JaxTrainer(jenc, seed=3), EmbeddingTrainer(tenc, seed=3)
    batch = _batch()[:8]
    capture = _capture()
    step = jt._make_train_step(capture)
    tok = jenc.tokenizer
    ids_a, mask_a = tok.encode_batch([b.texts[0] for b in batch], 32)
    ids_b, mask_b = tok.encode_batch([b.texts[1] for b in batch], 32)
    labels = np.array([b.label for b in batch], np.float32)
    _, grads, jloss = step(jenc.params, capture.init(jenc.params),
                           ids_a, mask_a, ids_b, mask_b, labels)
    loss = tt._backward(batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    # the single-device loss of the same batch, and a data axis of 3 that
    # splits it 3 + 3 + 2 (each shard's loss weighted by its share)
    _, one = _pair()
    np.testing.assert_allclose(
        EmbeddingTrainer(one).loss(batch).item(), loss.item(), rtol=1e-6)
    _, three = _pair(tmesh=_meshes(1, 3)[1])
    np.testing.assert_allclose(EmbeddingTrainer(three)._backward(batch)
                               .item(), loss.item(), rtol=1e-6)
    for module in (tenc.encoder, tenc.head):
        for p in module.parameters():
            p.data = p.grad
    got, want = _flat(_port_tree(tt)), _flat(grads)
    largest = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-5 * largest, err_msg=key)


@pytest.mark.parametrize("corpus,data", [(4, 2), (1, 3)])
def test_data_parallel_adamw_steps_equal_jax(corpus, data):
    """Five steps of 6 examples at warmup 2 (the first update is zero):
    the JAX mesh needs the data axis to divide the batch; the port's 3-way
    axis splits 6 into 2 + 2 + 2."""
    jm, tm = _meshes(corpus, data)
    jenc, tenc = _pair(jm, tm)
    jt, tt = JaxTrainer(jenc, seed=3), EmbeddingTrainer(tenc, seed=3)
    examples = _batch()[:30]
    kw = dict(batch_size=6, warmup_steps=2, learning_rate=LR, log_every=1)
    sj = jt.fine_tune(examples, **kw)
    st = tt.fine_tune(examples, **kw)
    np.testing.assert_allclose(st["losses"], sj["losses"], rtol=0, atol=1e-5)
    got, want = _flat(_port_tree(tt)), _flat(jenc.params)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    # the replicas serve the trained weights
    np.testing.assert_allclose(
        tenc.encode(TEXTS[:4]), jenc.encode(TEXTS[:4]), rtol=0,
        atol=EMB_ATOL)


def test_data_parallel_lora_equals_jax():
    jcfg, params, tcfg, tree = _setup(layers=2)
    jm, tm = _meshes(1, 2)
    jt = jl.LoraTrainer(jcfg, params, rank=4, alpha=4.0, seed=0, mesh=jm)
    tt = tl.LoraTrainer(tcfg, tree, rank=4, alpha=4.0, seed=0, mesh=tm)
    one = tl.LoraTrainer(tcfg, tree, rank=4, alpha=4.0, seed=0,
                         device="cpu")
    kw = dict(epochs=2, batch_size=4, max_len=48, log_every=1)
    want = jt.fit(QA, **kw)
    got = tt.fit(QA, **kw)
    assert got["steps"] == want["steps"] == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["losses"], one.fit(QA, **kw)["losses"],
                               rtol=0, atol=1e-5)
    _assert_trees(tt.merged_params(), jt.merged_params(), atol=1e-5,
                  ordered=False)
