"""train/lora.py of the port against the JAX package's LoRA, on the CPU.

The base tree comes from the Flax `LlamaDecoder.init` (insertion order:
``layer_0 ... layer_10``, not sorted) and is handed to the port as numpy
in that order. Tolerances: `init_lora` bit-equal (the same numpy draws in
the same order); `merge_lora` within 1e-6 (the A @ B product sums in
another order); the LoRA loss within 1e-6 relative and its gradients
within 1e-5 of the largest; `fit` losses within 1e-4 (f32 through the
decoder and AdamW's normalised steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu.gen.generator import ByteTokenizer as JaxBytes
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu.train import lora as jl

from persian_rag_tpu_torch.gen.generator import ByteTokenizer
from persian_rag_tpu_torch.models import decoder as td
from persian_rag_tpu_torch.train import lora as tl

LAYERS = 11  # layer_10 sorts before layer_2
QA = [
    {"question": "دارو چیست؟", "answer": "ماده درمانی"},
    {"question": "قلب چیست؟", "answer": "عضو پمپاژ خون"},
    {"question": "", "answer": "بدون پرسش"},
    {"question": "کبد چه می کند؟", "answer": "تصفیه سموم"},
    {"question": "واکسن؟", "answer": "پیشگیری از بیماری های واگیر"},
] * 3


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _map(fn, tree):
    """tree_map in the tree's own key order (jax's sorts the keys)."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), np.array(value)


def _setup(layers=LAYERS, seed=0):
    fields = dict(vocab_size=ByteTokenizer.vocab_size, num_layers=layers)
    jcfg = jd.DecoderConfig.tiny(**fields)
    params = jd.LlamaDecoder(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, td.DecoderConfig.tiny(**fields), _np_tree(params)


def _assert_trees(got, want, atol=0.0, ordered=True):
    got, want = list(_paths(got)), list(_paths(want))
    if not ordered:  # a jax.device_get tree comes back sorted
        got, want = sorted(got, key=lambda x: x[0]), sorted(
            want, key=lambda x: x[0])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if atol:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("rank,seed", [(4, 0), (32, 5)])
def test_init_lora_equals_jax(rank, seed):
    _, params, _, tree = _setup()
    want = jl.init_lora(params, rank=rank, seed=seed)
    got = tl.init_lora(tree, rank=rank, seed=seed)
    _assert_trees(got, want)
    assert list(got)[:3] == ["layer_0", "layer_1", "layer_2"]
    assert len(got) == LAYERS
    assert list(got["layer_0"]["attention"]) == ["q_proj", "k_proj",
                                                 "v_proj", "o_proj"]


def _random_b(lora, seed):
    """LoRA trees with nonzero B (both packages), as after training."""
    rng = np.random.default_rng(seed)
    np_lora = _np_tree(lora)
    for path, _ in list(_paths(np_lora)):
        if path[-1] == "b":
            node = np_lora
            for key in path[:-1]:
                node = node[key]
            node["b"] = (rng.standard_normal(node["b"].shape)
                         * 0.05).astype(np.float32)
    as_jax = _map(jnp.asarray, np_lora)
    as_torch = _map(torch.tensor, np_lora)
    return as_jax, as_torch


def test_merge_lora_equals_jax():
    _, params, _, tree = _setup()
    jlora, tlora = _random_b(jl.init_lora(params, rank=8, seed=1), seed=2)
    want = jl.merge_lora(params, jlora, alpha=16.0, rank=8)
    got = tl.merge_lora(tree, tlora, alpha=16.0, rank=8)
    _assert_trees(got, want, atol=1e-6)
    # B = 0: the merged tree is the base, bit for bit
    fresh = tl.init_lora(tree, rank=8)
    _assert_trees(tl.merge_lora(tree, fresh, alpha=16.0, rank=8), tree)


def _batch(tokenizer, max_len=48):
    examples = [tl.build_sft_example(q["question"], q["answer"], tokenizer,
                                     max_len) for q in QA[:4]]
    ids, labels, mask = tl.pad_batch(examples)
    return [np.pad(a, ((0, 0), (0, max_len - a.shape[1])),
                   constant_values=fill)
            for a, fill in ((ids, 0), (labels, -100), (mask, 0))]


def test_sft_examples_equal_jax():
    for q in QA[:5]:
        for max_len in (8, 256):
            got = tl.build_sft_example(q["question"], q["answer"],
                                       ByteTokenizer(), max_len)
            want = jl.build_sft_example(q["question"], q["answer"],
                                        JaxBytes(), max_len)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    examples = [jl.build_sft_example(q["question"], q["answer"], JaxBytes())
                for q in QA[:4]]
    for g, w in zip(tl.pad_batch(examples, pad_id=3),
                    jl.pad_batch(examples, pad_id=3)):
        np.testing.assert_array_equal(g, w)


def test_lora_loss_and_gradients_equal_jax():
    jcfg, params, tcfg, tree = _setup(layers=3)
    jt = jl.LoraTrainer(jcfg, params, rank=8, alpha=16.0, seed=4)
    tt = tl.LoraTrainer(tcfg, tree, rank=8, alpha=16.0, seed=4, device="cpu")
    jt.lora, tt.lora = _random_b(jt.lora, seed=6)
    _map(lambda leaf: leaf.requires_grad_(True), tt.lora)
    ids, labels, mask = _batch(JaxBytes())
    jloss, jgrads = jax.value_and_grad(jt._loss_fn)(
        jt.lora, params, jnp.asarray(ids), jnp.asarray(labels),
        jnp.asarray(mask))
    loss = tt.loss(*(torch.as_tensor(a, dtype=torch.long)
                     for a in (ids, labels, mask)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    grads = _map(lambda t: t.grad.numpy(), tt.lora)
    largest = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(jgrads))
    _assert_trees(grads, jgrads, atol=1e-5 * float(largest), ordered=False)


def test_fit_losses_equal_jax():
    jcfg, params, tcfg, tree = _setup(layers=2)
    jt = jl.LoraTrainer(jcfg, params, rank=4, alpha=4.0, seed=0)
    tt = tl.LoraTrainer(tcfg, tree, rank=4, alpha=4.0, seed=0, device="cpu")
    kw = dict(epochs=2, batch_size=4, max_len=48, log_every=1)
    want = jt.fit(QA, **kw)
    got = tt.fit(QA, **kw)
    assert got["steps"] == want["steps"] == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-4)
    assert np.mean(got["losses"][-2:]) < np.mean(got["losses"][:2])
    merged = tt.merged_params()
    _assert_trees(merged, jt.merged_params(), atol=1e-5, ordered=False)
    assert not merged["layer_0"]["attention"]["q_proj"]["kernel"].requires_grad


def test_merged_forward_equals_the_training_forward():
    _, _, tcfg, tree = _setup(layers=2)
    tt = tl.LoraTrainer(tcfg, tree, rank=4, alpha=4.0, device="cpu")
    tt.fit(QA, batch_size=4, max_len=48)
    ids, _, mask = (torch.as_tensor(a, dtype=torch.long)
                    for a in _batch(ByteTokenizer()))
    with torch.no_grad():
        trained = tt.logits(tt.lora, ids, mask)
        gen = td.LlamaDecoder(tcfg)
        from persian_rag_tpu_torch.models.convert import (
            decoder_params_from_flax,
        )
        gen.load_state_dict(decoder_params_from_flax(tt.merged_params()))
        served = gen(ids, attention_mask=mask)
    np.testing.assert_array_equal(served.numpy(), trained.numpy())


def test_fused_and_quantized_trees_are_refused():
    """The JAX init_lora quietly trains 2 of 7 projections of a fused
    tree and none of a quantized one; the port's LoraTrainer raises."""
    jcfg, params, tcfg, tree = _setup(layers=2)
    fused = jd.fuse_params(params)
    assert set(jl.init_lora(fused)["layer_0"]["attention"]) == {"o_proj"}
    assert set(jl.init_lora(fused)["layer_0"]["mlp"]) == {"down_proj"}
    assert jl.init_lora(jd.quantize_decoder_params(params)) == {}
    tfused = td.fuse_params(tl._tree_to(tree, "cpu"))
    assert set(tl.init_lora(tfused)["layer_0"]["attention"]) == {"o_proj"}
    with pytest.raises(ValueError, match="fused"):
        tl.LoraTrainer(tcfg, tfused, device="cpu")
    quantized = td.quantize_decoder_params(tl._tree_to(tree, "cpu"))
    assert tl.init_lora(quantized) == {}
    with pytest.raises(ValueError, match="quantized"):
        tl.LoraTrainer(tcfg, quantized, device="cpu")
    # a mesh is ported (tests/test_torch_parallel_encode_train.py): a
    # non-Mesh raises
    with pytest.raises(TypeError, match="Mesh"):
        tl.LoraTrainer(tcfg, tree, mesh=object(), device="cpu")
