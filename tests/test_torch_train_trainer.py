"""train/trainer.py of the port against the JAX package's EmbeddingTrainer,
on the CPU.

Both trainers start from the same Flax-initialised weights (converted with
`encoder_params_from_flax`) and see the same examples, built by each
package from the same seeded records. Tolerances: the loss within 1e-6
relative and the gradients within 1e-5 of the largest (XLA and ATen sum
in different orders); parameters after AdamW steps within 1e-5 at the
trainer's default rate (2e-5): the key bias's gradient is zero in exact
arithmetic (softmax ignores a shift of every key score), so Adam
normalises each framework's rounding noise there into a step of up to
the rate, which leaves half the rate of room; `fine_tune` losses within
1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from persian_rag_tpu.data.loader import synthetic_persian_qa
from persian_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHash
from persian_rag_tpu.train.trainer import EmbeddingTrainer as JaxTrainer

from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
    params_to_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer, HFTokenizer
from persian_rag_tpu_torch.pipelines.common import build_encoder
from persian_rag_tpu_torch.train import EmbeddingTrainer, InputExample
from persian_rag_tpu_torch.train.trainer import warmup_linear

SMALL = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
ARCHS = {
    "bert": ({}, (None, False)),
    "xlmr_normalize": (dict(type_vocab_size=1, layer_norm_eps=1e-5,
                            position_offset=2, pad_token_id=1), (None, True)),
    "distilbert_projection": (dict(type_vocab_size=0), (16, False)),
}
LR = 2e-5  # TrainingConfig.learning_rate
EMB_ATOL = 1e-4  # tests/test_torch_encoder.py: 2 layers, two frameworks


def _np_tree(tree):
    """A Flax tree as numpy, in its own key order."""
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    """{path: a copy} (a port tree's leaves share the parameters' memory)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.array(value)
    return out


def _pair(arch="bert", seed=3):
    """(JAX trainer, port trainer) over the same weights."""
    overrides, (proj, normalize) = ARCHS[arch]
    jenc = JaxEncoder(JaxConfig(**SMALL, **overrides), projection_dim=proj,
                      normalize=normalize, tokenizer=JaxHash(512),
                      max_seq_len=32, seed=seed)
    tree = _np_tree(jenc.params)
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL, **overrides),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        projection_dim=proj, normalize=normalize,
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(512), max_seq_len=32, device="cpu")
    return JaxTrainer(jenc, seed=seed), EmbeddingTrainer(tenc, seed=seed)


def _port_tree(trainer):
    enc = trainer.encoder
    return {"encoder": params_to_flax(enc.encoder),
            "head": params_to_flax(enc.head)}


def _as_pairs(examples):
    return [(list(e.texts), e.label) for e in examples]


def _records(n=40, seed=1):
    records = synthetic_persian_qa(n, seed=seed)
    # the filters: a missing question, a missing answer, a short context
    records[3] = dict(records[3], question="")
    records[5] = dict(records[5], answer=None)
    records[7] = dict(records[7], context="کوتاه")
    return records


@pytest.mark.parametrize("seed", [0, 7])
def test_example_lists_equal_jax(seed):
    jt, tt = _pair(seed=seed)
    records = _records()
    assert _as_pairs(tt.prepare_training_data(records)) == _as_pairs(
        jt.prepare_training_data(records))
    assert _as_pairs(tt._create_negative_examples(records, 25)) == _as_pairs(
        jt._create_negative_examples(records, 25))
    many = synthetic_persian_qa(130, seed=seed)
    assert _as_pairs(tt.prepare_evaluation_data(many)) == _as_pairs(
        jt.prepare_evaluation_data(many))
    assert tt.prepare_training_data([]) == []


def _capture():
    """An optax transformation whose state is the gradient and whose
    update is zero: JAX's own train step then returns its gradients."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa
    return optax.GradientTransformation(
        lambda params: zeros(params),
        lambda grads, state, params=None: (zeros(grads), grads))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_step_loss_and_gradients_equal_jax(arch):
    jt, tt = _pair(arch)
    batch = jt.prepare_training_data(_records())[:8]
    capture = _capture()
    step = jt._make_train_step(capture)
    tok = jt.encoder.tokenizer
    ids_a, mask_a = tok.encode_batch([b.texts[0] for b in batch], 32)
    ids_b, mask_b = tok.encode_batch([b.texts[1] for b in batch], 32)
    labels = np.array([b.label for b in batch], np.float32)
    _, grads, jloss = step(jt.encoder.params, capture.init(jt.encoder.params),
                           ids_a, mask_a, ids_b, mask_b, labels)

    loss = tt.loss([InputExample(list(b.texts), b.label) for b in batch])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for module in (tt.encoder.encoder, tt.encoder.head):
        for p in module.parameters():
            p.data = p.grad  # params_to_flax then lays the gradients out
    got, want = _flat(_port_tree(tt)), _flat(grads)
    assert sorted(got) == sorted(want)
    largest = max(np.abs(g).max() for g in want.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-5 * largest, err_msg=key)


def test_schedule_equals_optax():
    for lr, warmup, total in ((2e-5, 50, 313), (1e-3, 2, 5), (3e-4, 0, 7),
                              (1e-4, 9, 4)):
        jax_schedule = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, max(warmup, 1)),
             optax.linear_schedule(lr, 0.0, max(total - warmup, 1))],
            [max(warmup, 1)])
        rate = warmup_linear(lr, warmup, total)
        for count in range(total + 3):
            assert rate(count) == float(jax_schedule(count)), (lr, count)
        assert rate(0) == 0.0


@pytest.mark.parametrize("steps", [1, 5])
def test_adamw_steps_equal_jax(steps):
    """Batches of 4 and warmup 2: update 0 moves nothing (rate 0), update
    2 is the first of the decay piece."""
    jt, tt = _pair("distilbert_projection")
    records = _records()
    before = _flat(_port_tree(tt))
    jt.fine_tune(jt.prepare_training_data(records)[:4 * steps], batch_size=4,
                 warmup_steps=2, learning_rate=LR, log_every=1)
    tt.fine_tune(tt.prepare_training_data(records)[:4 * steps], batch_size=4,
                 warmup_steps=2, learning_rate=LR, log_every=1)
    got, want = _flat(_port_tree(tt)), _flat(jt.encoder.params)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
        if steps == 1:  # the zero first update, decay included
            np.testing.assert_array_equal(got[key], before[key])
    if steps == 5:
        assert max(np.abs(got[k] - before[k]).max() for k in got) > 1e-5


def test_fine_tune_losses_equal_jax_over_two_epochs():
    jt, tt = _pair("xlmr_normalize")
    records = _records(24, seed=2)
    kw = dict(epochs=2, batch_size=8, warmup_steps=2, learning_rate=1e-3,
              log_every=1)
    examples = tt.prepare_training_data(records)
    sj = jt.fine_tune(jt.prepare_training_data(records), **kw)
    st = tt.fine_tune(examples, **kw)
    assert len(st["losses"]) == len(sj["losses"]) == 2 * (len(examples) // 8)
    np.testing.assert_allclose(st["losses"], sj["losses"], rtol=0, atol=1e-5)
    assert set(st) == set(sj)
    assert st["final_loss"] == st["losses"][-1]


def test_evaluate_and_helpers_equal_jax():
    jt, tt = _pair("bert")
    examples = jt.prepare_evaluation_data(_records())
    port = [InputExample(list(e.texts), e.label) for e in examples]
    assert abs(tt.evaluate(port) - jt.evaluate(examples)) < 1e-5
    texts = ["دارو برای درمان", "قلب و خون"]
    np.testing.assert_allclose(tt.encode_texts(texts), jt.encode_texts(texts),
                               rtol=0, atol=EMB_ATOL)
    assert abs(tt.get_similarity(*texts) - jt.get_similarity(*texts)) < 1e-4
    summary = tt.fine_tune(tt.prepare_training_data(_records(16)),
                           eval_examples=port, batch_size=8)
    assert "eval_spearman_proxy" in summary


@pytest.mark.parametrize("arch", list(ARCHS))
def test_save_model_writes_the_jax_files(arch, tmp_path):
    """A fresh model's files are byte-equal to the JAX package's."""
    jt, tt = _pair(arch)
    jt.save_model(str(tmp_path / "jax"))
    tt.save_model(str(tmp_path / "port"))
    for name in ("params.msgpack", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name
    assert not (tmp_path / "port" / "tokenizer.json").exists()


def test_jax_trained_model_loads_in_the_port(tmp_path):
    jt, _ = _pair("distilbert_projection")
    jt.fine_tune(jt.prepare_training_data(_records()), batch_size=8,
                 warmup_steps=1, learning_rate=1e-3)
    path = str(tmp_path / "m")
    jt.save_model(path)
    enc = EmbeddingTrainer.load_model(path, device="cpu")
    got = _flat({"encoder": params_to_flax(enc.encoder),
                 "head": params_to_flax(enc.head)})
    want = _flat(jt.encoder.params)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (enc.max_seq_len, enc.dim) == (32, 16)
    texts = ["دارو برای درمان سردرد", "یک"]
    np.testing.assert_allclose(enc.encode(texts), jt.encoder.encode(texts),
                               rtol=0, atol=EMB_ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_port_trained_model_loads_in_jax(remat, tmp_path):
    _, tt = _pair("xlmr_normalize")
    if remat:  # the field travels in config.json; the step is unchanged
        tt.encoder.config = EncoderConfig(**SMALL, **ARCHS["xlmr_normalize"][0],
                                          remat=True)
        tt.encoder.encoder.config = tt.encoder.config
    summary = tt.fine_tune(tt.prepare_training_data(_records()), batch_size=8,
                           warmup_steps=1, learning_rate=1e-3, log_every=1,
                           output_path=str(tmp_path / "m"))
    assert summary["model_path"] == str(tmp_path / "m")
    jenc = JaxTrainer.load_model(str(tmp_path / "m"), tokenizer=JaxHash(512))
    assert jenc.config.remat is remat and jenc.head.normalize
    got, want = _flat(jenc.params), _flat(_port_tree(tt))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_remat_gives_the_same_step():
    records = _records()
    trees = []
    for remat in (False, True):
        _, tt = _pair("bert")
        if remat:
            tt.encoder.encoder.config = EncoderConfig(**SMALL, remat=True)
        tt.fine_tune(tt.prepare_training_data(records)[:12], batch_size=4,
                     warmup_steps=1, learning_rate=1e-3)
        trees.append(_flat(_port_tree(tt)))
    for key in trees[0]:
        np.testing.assert_array_equal(trees[1][key], trees[0][key])


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """4 steps with a checkpoint every 3: a fresh trainer resumed from
    step 3 takes step 4 and ends with the uninterrupted run's parameters,
    bit for bit."""
    records = _records()
    kw = dict(batch_size=4, warmup_steps=2, learning_rate=1e-3, log_every=1)
    _, full = _pair("bert")
    examples = full.prepare_training_data(records)[:16]
    ckpt = str(tmp_path / "ckpt")
    summary = full.fine_tune(examples, checkpoint_dir=ckpt,
                             checkpoint_every=3, **kw)
    with open(os.path.join(ckpt, "train_state.json")) as f:
        assert json.load(f) == {"step": 3}
    _, resumed = _pair("bert")
    tail = resumed.fine_tune(examples, checkpoint_dir=ckpt, resume=True, **kw)
    assert len(summary["losses"]) == 4 and len(tail["losses"]) == 1
    assert tail["losses"][0] == summary["losses"][-1]
    want, got = _flat(_port_tree(full)), _flat(_port_tree(resumed))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _config(tmp_path):
    config = Config()
    config.paths.models_dir = str(tmp_path / "models")
    return config


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_build_encoder_picks_the_finetuned_directory(writer, tmp_path):
    name = "sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2"
    config = _config(tmp_path)
    jt, tt = _pair("bert")
    trainer = jt if writer == "jax" else tt
    trainer.save_model(os.path.join(config.paths.models_dir,
                                    "paraphrase-multilingual-MiniLM-L12-v2"
                                    "_finetuned"))
    enc = build_encoder(name, config, device="cpu")
    assert enc.config == EncoderConfig(**SMALL)  # not the MiniLM preset
    texts = ["دارو برای درمان سردرد"]
    np.testing.assert_allclose(enc.encode(texts), tt.encoder.encode(texts),
                               rtol=0, atol=0)


def test_tokenizer_survives_reload_where_jax_loses_it(tmp_path):
    """The JAX save_model writes no tokenizer, so load_model builds the
    hash tokenizer; the port keeps the model's tokenizer.json."""
    pytest.importorskip("tokenizers")
    from test_torch_tokenizer_json import _wordpiece

    tok_path = tmp_path / "tok" / "tokenizer.json"
    tok_path.parent.mkdir()
    _wordpiece(str(tok_path), False)
    tok = HFTokenizer(str(tok_path.parent))
    cfg = EncoderConfig(**{**SMALL, "vocab_size": tok.vocab_size})
    enc = SentenceEncoder(cfg, tokenizer=tok, max_seq_len=32, device="cpu")
    EmbeddingTrainer(enc).save_model(str(tmp_path / "port"))
    loaded = EmbeddingTrainer.load_model(str(tmp_path / "port"), device="cpu")
    texts = ["دارو برای درمان سردرد چیست", "Hello World"]
    assert isinstance(loaded.tokenizer, HFTokenizer)
    for got, want in zip(loaded.tokenizer.encode_batch(texts, 32),
                         tok.encode_batch(texts, 32)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(loaded.encode(texts), enc.encode(texts))

    from persian_rag_tpu.models.tokenizer import HFTokenizer as JaxHF

    jcfg = JaxConfig(**{**SMALL, "vocab_size": tok.vocab_size})
    jenc = JaxEncoder(jcfg, tokenizer=JaxHF(str(tok_path.parent)),
                      max_seq_len=32)
    JaxTrainer(jenc).save_model(str(tmp_path / "jax"))
    reloaded = JaxTrainer.load_model(str(tmp_path / "jax"))
    assert isinstance(reloaded.tokenizer, JaxHash)  # the JAX fault
    assert not np.array_equal(reloaded.tokenizer.encode_batch(texts, 32)[0],
                              tok.encode_batch(texts, 32)[0])


def test_mesh_raises(tmp_path):
    """The mesh is ported (tests/test_torch_parallel_encode_train.py):
    load_model onto a mesh encodes data-parallel; a non-Mesh raises."""
    _, tt = _pair()
    tt.save_model(str(tmp_path))
    with pytest.raises(TypeError, match="Mesh"):
        EmbeddingTrainer.load_model(str(tmp_path), mesh=object())
    mesh = build_mesh(1, 2, devices=["cpu", "cpu"])
    enc = EmbeddingTrainer.load_model(str(tmp_path), mesh=mesh)
    assert enc.mesh is mesh and enc.device == torch.device("cpu")
    texts = ["یک", "دو سه", "چهار"]
    np.testing.assert_allclose(enc.encode(texts), tt.encoder.encode(texts),
                               atol=1e-5)
