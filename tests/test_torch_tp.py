"""parallel/tp.py of the port against the JAX package's tensor-parallel
encoder placement, on the CPU.

`shard_params_tensor_parallel` without a config applies the JAX per-leaf
rule: every shard has the shape of the JAX leaf's shard on conftest's 8
virtual CPU devices (dims the axis does not divide stay whole). The
forward (`TensorParallelEncoder`, whole-head attention splits) holds the
port's single-device encoder within 2e-5 (the JAX TP tests' own limit)
and the JAX tensor-parallel `encode` within the cross-framework EMB_ATOL
of tests/test_torch_train_trainer.py.
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
from persian_rag_tpu.parallel.tp import (
    shard_params_tensor_parallel as jshard,
)
from persian_rag_tpu_torch.core.mesh import build_mesh
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer
from persian_rag_tpu_torch.parallel.tp import (
    TensorParallelEncoder,
    shard_params_tensor_parallel,
)

from test_torch_train_trainer import EMB_ATOL, _np_tree

CONFIGS = {
    # every shardable dim divides 8; 4 heads: the forward splits the
    # attention at 4 shards and keeps it whole at 8
    "tiny": dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=64),
    # hidden 36 and FFN 52 do not divide over 8 shards: replicated leaves
    "indivisible": dict(vocab_size=128, hidden_size=36, num_layers=1,
                        num_heads=4, intermediate_size=52,
                        max_position_embeddings=32),
}
TEXTS = ["دارو برای درمان", "a test sentence", "short"]


def _meshes(n):
    return (jbuild(n, 1, devices=jax.devices()[:n]),
            build_mesh(n, 1, devices=["cpu"] * n))


def _pair(name, seed=2):
    vocab = CONFIGS[name]["vocab_size"]
    jenc = JaxEncoder(JaxConfig(**CONFIGS[name]), tokenizer=JaxHash(vocab),
                      seed=seed)
    tree = _np_tree(jenc.params)
    tenc = SentenceEncoder(
        EncoderConfig(**CONFIGS[name]),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        tokenizer=HashTokenizer(vocab), device="cpu")
    return jenc, tenc, tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("n", [4, 8])
def test_placement_shapes_equal_jax(name, n):
    jenc, _, tree = _pair(name)
    jm, tm = _meshes(n)
    want = dict(_leaves(jshard(jenc.params["encoder"], jm, axis="corpus")))
    got = dict(_leaves(shard_params_tensor_parallel(tree["encoder"], tm)))
    assert sorted(got) == sorted(want)
    for path, parts in got.items():
        assert len(parts) == n
        assert tuple(parts[0].shape) == tuple(
            want[path].addressable_shards[0].data.shape), path
    q = got[("layer_0", "attention", "query", "kernel")][0]
    norm = got[("layer_0", "attention_norm", "scale")][0]
    assert norm.shape == (CONFIGS[name]["hidden_size"],)
    if name == "tiny":
        assert q.shape == (64, 64 // n)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("n", [1, 4, 8])
def test_tp_embeddings_equal_single_and_jax(name, n):
    jenc, tenc, tree = _pair(name)
    single = tenc.encode(TEXTS, batch_size=4)
    jm, tm = _meshes(n)
    tp = TensorParallelEncoder(tenc.config, tree["encoder"], tm)
    ids, mask = tenc.tokenizer.encode_batch(TEXTS + [""], tenc.max_seq_len)
    with torch.no_grad():
        got = tenc.head(tp(ids, mask), torch.as_tensor(mask)).numpy()[:3]
    np.testing.assert_allclose(got, single, rtol=0, atol=2e-5)
    jenc.params = {"encoder": jshard(jenc.params["encoder"], jm),
                   "head": jenc.params["head"]}
    jenc._jit_cache.clear()
    np.testing.assert_allclose(got, jenc.encode(TEXTS, batch_size=4),
                               rtol=0, atol=EMB_ATOL)
    # the attention block splits on whole heads, the FFN by its width
    split_q = tp.tp["layer_0"]["attention"]["query"]["kernel"][0].shape[1]
    split_f = tp.tp["layer_0"]["intermediate"]["kernel"][0].shape[1]
    cfg = tenc.config
    assert split_q == (cfg.hidden_size // n if cfg.num_heads % n == 0
                       else cfg.hidden_size)
    assert split_f == (cfg.intermediate_size // n
                       if cfg.intermediate_size % n == 0
                       else cfg.intermediate_size)
