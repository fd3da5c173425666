"""The port's encoder stack against the Flax modules, on the CPU.

The same random Flax weights are converted to torch state dicts and the
same token ids go through both. The tolerance is 1e-4 absolute in f32:
XLA and ATen sum in different orders through 2 layers of attention, FFN
and LayerNorm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    # transformers probes optional packages (faiss among them) with
    # importlib.util.find_spec at its FIRST import, which raises on a stub
    # module without a __spec__; tests/test_reference_parity.py leaves such
    # stubs in sys.modules when its fixture fails. Importing it while the
    # tests are collected keeps the tests that compare with transformers
    # (test_encoder_parity.py, test_decoder.py) independent of which tests
    # ran before them in the same process.
    import transformers  # noqa: F401
except ImportError:
    pass

from persian_rag_tpu.models.encoder import EncoderConfig as JaxConfig
from persian_rag_tpu.models.encoder import TransformerEncoder as JaxEncoder
from persian_rag_tpu.models.pooling import PoolingHead as JaxHead
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer

from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    TransformerEncoder,
)
from persian_rag_tpu_torch.models.pooling import PoolingHead
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.models.tokenizer import HashTokenizer

ATOL = 1e-4

SMALL = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128)
# (name, config overrides, head: (pooling, projection_dim, normalize))
ARCHS = [
    ("bert", {}, ("mean", None, False)),
    ("distilbert", dict(type_vocab_size=0), ("mean", 32, False)),
    ("xlmr", dict(max_position_embeddings=514, type_vocab_size=1,
                  layer_norm_eps=1e-5, position_offset=2, pad_token_id=1),
     ("mean", None, True)),
]

TEXTS = [
    "دارو برای درمان سردرد چیست",
    "بیمارستان امام خمینی در تهران",
    "قانون اساسی جمهوری اسلامی ایران",
    "",
    "شعر حافظ و سعدی در ادبیات فارسی " * 3,
    "یک",
]


def _configs(overrides):
    return JaxConfig(**SMALL, **overrides), EncoderConfig(**SMALL, **overrides)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("name,overrides,head", ARCHS, ids=[a[0] for a in ARCHS])
def test_weight_conversion_covers_every_parameter(name, overrides, head):
    jcfg, tcfg = _configs(overrides)
    jenc = JaxSentenceEncoder(jcfg, pooling=head[0], projection_dim=head[1],
                              normalize=head[2])
    state = encoder_params_from_flax(_numpy_tree(jenc.params["encoder"]))
    module = TransformerEncoder(tcfg)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    kernel = np.asarray(
        jenc.params["encoder"]["layer_1"]["intermediate"]["kernel"]
    )
    np.testing.assert_array_equal(
        state["layers.1.intermediate.weight"].numpy(), kernel.T
    )
    hstate = head_params_from_flax(_numpy_tree(jenc.params["head"]))
    hmod = PoolingHead(tcfg.hidden_size, pooling=head[0],
                       projection_dim=head[1], normalize=head[2])
    assert set(hstate) == set(hmod.state_dict())


def _port_encoder(jenc, tcfg, head):
    return SentenceEncoder(
        tcfg,
        state_dict=encoder_params_from_flax(_numpy_tree(jenc.params["encoder"])),
        pooling=head[0], projection_dim=head[1], normalize=head[2],
        head_state_dict=head_params_from_flax(_numpy_tree(jenc.params["head"])),
        tokenizer=HashTokenizer(tcfg.vocab_size), max_seq_len=32,
        device="cpu",
    )


@pytest.mark.parametrize("name,overrides,head", ARCHS, ids=[a[0] for a in ARCHS])
def test_encoder_and_head_match_flax(name, overrides, head):
    jcfg, tcfg = _configs(overrides)
    jenc = JaxSentenceEncoder(
        jcfg, pooling=head[0], projection_dim=head[1], normalize=head[2],
        tokenizer=JaxHashTokenizer(jcfg.vocab_size), max_seq_len=32, seed=3,
    )
    tenc = _port_encoder(jenc, tcfg, head)
    ids, mask = JaxHashTokenizer(jcfg.vocab_size).encode_batch(TEXTS, 32)
    want_h = JaxEncoder(jcfg).apply(
        {"params": jenc.params["encoder"]}, jnp.asarray(ids), jnp.asarray(mask)
    )
    with torch.no_grad():
        got_h = tenc.encoder(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask).long())
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)
    want_e = JaxHead(pooling=head[0], projection_dim=head[1],
                     normalize=head[2]).apply(
        {"params": jenc.params["head"]}, want_h, jnp.asarray(mask)
    )
    with torch.no_grad():
        got_e = tenc.head(torch.tensor(np.asarray(want_h)),
                          torch.from_numpy(mask).long())
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL)


@pytest.mark.parametrize("name,overrides,head", ARCHS, ids=[a[0] for a in ARCHS])
def test_sentence_encoder_encode_matches_flax(name, overrides, head):
    jcfg, tcfg = _configs(overrides)
    jenc = JaxSentenceEncoder(
        jcfg, pooling=head[0], projection_dim=head[1], normalize=head[2],
        tokenizer=JaxHashTokenizer(jcfg.vocab_size), max_seq_len=32, seed=5,
    )
    tenc = _port_encoder(jenc, tcfg, head)
    texts = TEXTS * 3  # 18 texts: two batches of 8 and a padded third
    want = jenc.encode(texts, batch_size=8)
    got = tenc.encode(texts, batch_size=8)
    assert got.shape == want.shape == (len(texts), tenc.dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    dev = tenc.encode_device(texts[:5])
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_allclose(dev.numpy(), want[:5], atol=ATOL)


def test_seeded_random_weights_are_reproducible():
    cfg = EncoderConfig(**SMALL)
    a = SentenceEncoder(cfg, seed=7, device="cpu").encode(TEXTS)
    b = SentenceEncoder(cfg, seed=7, device="cpu").encode(TEXTS)
    c = SentenceEncoder(cfg, seed=8, device="cpu").encode(TEXTS)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and not np.allclose(a, c)


def test_minilm_preset_matches_jax():
    for preset in ("minilm_l12", "distilbert_base", "xlmr_base"):
        j = getattr(JaxConfig, preset)()
        t = getattr(EncoderConfig, preset)()
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "intermediate_size", "max_position_embeddings",
                      "type_vocab_size", "layer_norm_eps", "position_offset",
                      "pad_token_id", "hidden_act"):
            assert getattr(t, field) == getattr(j, field), (preset, field)


@pytest.mark.parametrize("max_len", [4, 16, 128, 300])
def test_hash_tokenizer_ids_identical(max_len):
    texts = TEXTS + ["کتاب‌های  درسی\tدانشگاه\nتهران ۱۴۰۲", "a b c"]
    for vocab in (1000, 250037):
        j = JaxHashTokenizer(vocab)
        t = HashTokenizer(vocab)
        for text in texts:
            assert t.encode(text, max_len) == j.encode(text, max_len)
        got_ids, got_mask = t.encode_batch(texts, max_len)
        want_ids, want_mask = j.encode_batch(texts, max_len)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert got_ids.dtype == want_ids.dtype == np.int32
