"""The port's GGUF module, TextGenerator.from_gguf and CLI against the JAX
package's, on the CPU.

Q8_0 blocks, written files, dequantized trees and the served int8 values
and scales must be equal; greedy streams equal (or parting at a near tie
of the bf16 logits, as tests/test_torch_generator.py allows quantized
streams); the embedded tokenizer's ids and text equal. The tiny model has
a byte-level BPE tokenizer with the Llama-3 split, trained in
tests/test_torch_tokenizer_json.py.
"""
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from persian_rag_tpu import __main__ as jmain
from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu.models import gguf as jgguf

from persian_rag_tpu_torch import __main__ as tmain
from persian_rag_tpu_torch.gen import generator as tg
from persian_rag_tpu_torch.gen.local_server import LocalGenerationServer
from persian_rag_tpu_torch.models import decoder as td
from persian_rag_tpu_torch.models import gguf as tgguf
from persian_rag_tpu_torch.models.tokenizer import HFTokenizer
from test_torch_tokenizer_json import TEXTS, _llama3_bpe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 5e-2
PROMPTS = ["دارو برای درمان سردرد", "they're sure we'll see", "سال ۱۴۰۲"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A BPE tokenizer.json, a tiny f32 tree for its vocabulary (tied and
    untied) and the JAX package's Q8_0 GGUF of each."""
    root = tmp_path_factory.mktemp("gguf")
    tok_path = str(root / "tokenizer.json")
    _llama3_bpe(tok_path)
    vocab = HFTokenizer(tok_path).vocab_size
    meta = jgguf.tokenizer_metadata_from_hf(tok_path)
    out = {"tok": tok_path, "meta": meta, "root": root}
    for tied in (True, False):
        cfg = jd.DecoderConfig.tiny(vocab_size=vocab, tie_word_embeddings=tied)
        params = _np_tree(jd.LlamaDecoder(cfg).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"])
        path = str(root / f"tiny_{'tied' if tied else 'untied'}.gguf")
        jgguf.write_decoder_gguf(path, cfg, params, quant="q8_0",
                                 extra_metadata=meta)
        out[tied] = (cfg, params, path)
    return out


def _rows(seed, n=64 * 32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[:32] = 0.0                                      # an all-zero block
    x[32:64] = np.arange(32) - 15.5                   # halves: ties in rint
    x[64:96] *= 1e4
    x[96:128] = rng.integers(-127, 128, 32) * np.float32(0.25)
    return x


def test_q8_0_bytes_equal_jax():
    for seed in range(3):
        x = _rows(seed)
        want = jgguf.quantize_q8_0(x)
        got = tgguf.quantize_q8_0(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tgguf.dequantize_q8_0(torch.from_numpy(got), x.size).numpy(),
            jgguf.dequantize_q8_0(want, x.size))


def test_q4_0_round_trip_and_dequant_equal_jax():
    x = _rows(4)
    raw = tgguf.quantize_q4_0(torch.from_numpy(x))
    assert raw.numel() == x.size // 32 * 18
    got = tgguf.dequantize_q4_0(raw, x.size).numpy()
    np.testing.assert_array_equal(got, jgguf.dequantize_q4_0(raw.numpy(),
                                                             x.size))
    # levels -8..7 of d = max / -8: within one step (the side opposite
    # the largest weight clamps at 7), plus the fp16 rounding of d
    d = np.abs(raw.numpy().reshape(-1, 18)[:, :2].copy().view(np.float16)
               .astype(np.float32))[:, 0]
    err = np.abs(got - x).reshape(-1, 32).max(axis=1)
    assert np.all(err <= d + 8 * 2.0 ** -11 * d)
    random_bytes = np.random.default_rng(5).integers(
        0, 256, 18 * 40, dtype=np.uint8)
    random_bytes.reshape(40, 18)[:, 1] &= 0x3B  # finite fp16 scales
    np.testing.assert_array_equal(
        tgguf.dequantize_q4_0(torch.from_numpy(random_bytes), 40 * 32).numpy(),
        jgguf.dequantize_q4_0(random_bytes, 40 * 32))


def test_permutations_equal_jax():
    w = np.random.default_rng(0).standard_normal((32, 12)).astype(np.float32)
    for heads in (2, 4):
        to = tgguf.permute_hf_to_gguf(torch.from_numpy(w), heads).numpy()
        np.testing.assert_array_equal(to, jgguf.permute_hf_to_gguf(w, heads))
        np.testing.assert_array_equal(
            tgguf.permute_gguf_to_hf(torch.from_numpy(to), heads).numpy(), w)


@pytest.mark.parametrize("quant", ["q8_0", "f16", "f32"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_write_decoder_gguf_bytes_equal_jax(assets, tmp_path, quant, tied):
    cfg, params, _ = assets[tied]
    tcfg = td.DecoderConfig.tiny(vocab_size=cfg.vocab_size,
                                 tie_word_embeddings=tied)
    want, got = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    jgguf.write_decoder_gguf(want, cfg, params, quant=quant,
                             extra_metadata=assets["meta"])
    tmeta = tgguf.tokenizer_metadata_from_hf(assets["tok"])
    tgguf.write_decoder_gguf(got, tcfg, params, quant=quant,
                             extra_metadata=tmeta)
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()


def test_write_gguf_q4_0_reads_back_equal(assets, tmp_path):
    """A Q4_0 file (the port's writer takes the type; the JAX one reads it)
    dequantizes to the same tree in both packages."""
    cfg, params, path = assets[True]
    gf = tgguf.GGUFFile(path)
    tensors = {name: (gf.tensor(name), tgguf.GGML_Q4_0 if len(info.shape) == 2
                      else tgguf.GGML_F32)
               for name, info in gf.tensors.items()}
    q4 = str(tmp_path / "q4.gguf")
    tgguf.write_gguf(q4, gf.metadata, tensors)
    gf.close()
    _, got = tgguf.params_from_gguf(q4)
    _, want = jgguf.params_from_gguf(q4)
    _assert_trees_equal(got, want)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                      err_msg=path)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_params_from_gguf_equal_jax(assets, tied):
    path = assets[tied][2]
    tcfg, got = tgguf.params_from_gguf(path, device="cpu")
    jcfg, want = jgguf.params_from_gguf(path)
    _assert_trees_equal(got, want)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "num_kv_heads", "intermediate_size",
                  "max_position_embeddings", "rms_norm_eps", "rope_theta",
                  "tie_word_embeddings"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_gguf_tokenizer_equals_jax(assets):
    gf, jgf = tgguf.GGUFFile(assets[True][2]), jgguf.GGUFFile(assets[True][2])
    got, want = tgguf.tokenizer_from_gguf(gf), jgguf.tokenizer_from_gguf(jgf)
    assert (got.bos_id, got.eos_id, got.pad_id, got.vocab_size) == (
        want.bos_id, want.eos_id, want.pad_id, want.vocab_size)
    for text in TEXTS + ["<|eot_id|> سلام <|begin_of_text|>"]:
        ids = want.encode(text)
        assert got.encode(text) == ids, text
        assert got.encode(text, add_bos=False) == want.encode(text,
                                                              add_bos=False)
        assert got.decode(ids) == want.decode(ids), text
        assert got.decode(ids) == text.replace("<|eot_id|>", "").replace(
            "<|begin_of_text|>", "")
    gf.close()
    jgf.close()


def _equal_or_near_tie(gen, prompt, got, want):
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    ids = torch.tensor([list(prompt) + list(want[:i])])
    with torch.no_grad():
        top = torch.topk(gen.model(ids)[0, -1].float(), 2).values
    assert float(top[0] - top[1]) < NEAR_TIE, (i, got, want)


@pytest.mark.parametrize("quantize", [None, "int4"], ids=["int8", "int4"])
def test_from_gguf_matches_jax(assets, quantize):
    path = assets[False][2]
    tgen = tg.TextGenerator.from_gguf(path, quantize=quantize, device="cpu")
    jgen = jg.TextGenerator.from_gguf(path, quantize=quantize)
    assert tgen.config.quantized_weights and jgen.config.quantized_weights
    assert tgen.config.quantized_bits == jgen.config.quantized_bits
    assert tgen.config.compute_dtype == torch.bfloat16
    if quantize is None:  # int8 values and scales equal the JAX package's
        jparams = _np_tree(jgen.params)
        for key in ("embed_tokens", "lm_head"):
            for leaf in ("values", "scale"):
                np.testing.assert_array_equal(
                    tgen.params[key][leaf].numpy(), jparams[key][leaf])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            for leaf in ("values", "scale"):
                np.testing.assert_array_equal(
                    tgen.params["layer_1"]["attention"][name][leaf].numpy(),
                    jparams["layer_1"]["attention"][name][leaf])
    for text in PROMPTS:
        prompt = jgen.tokenizer.encode(text)
        assert tgen.tokenizer.encode(text) == prompt
        want = jgen.generate_ids(prompt, max_tokens=12)
        got = tgen.generate_ids(prompt, max_tokens=12)
        _equal_or_near_tie(tgen, prompt, got, want)


def test_from_gguf_without_tokenizer_uses_bytes(assets, tmp_path):
    cfg, params, _ = assets[True]
    path = str(tmp_path / "bare.gguf")
    jgguf.write_decoder_gguf(path, cfg, params, quant="f16")
    gen = tg.TextGenerator.from_gguf(path, device="cpu")
    assert isinstance(gen.tokenizer, tg.ByteTokenizer)
    assert not gen.config.quantized_weights  # an f16 file serves as float
    assert tmain.main(["gen-serve", "--device", "cpu", "--gguf", path]) == 2


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_checkpoint(assets):
    """An HF LlamaForCausalLM directory (config.json, model.safetensors
    under HF names, tokenizer.json) of the untied tiny tree."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    cfg, params, _ = assets[False]
    path = assets["root"] / "hf_llama"
    path.mkdir()

    def w(leaf):
        return torch.from_numpy(np.array(leaf, order="C"))  # a writable copy

    sd = {"model.embed_tokens.weight": w(params["embed_tokens"]["embedding"]),
          "model.norm.weight": w(params["final_norm"]["scale"]),
          "lm_head.weight": w(params["lm_head"]["kernel"].T)}
    for i in range(cfg.num_layers):
        layer, p = params[f"layer_{i}"], f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = w(layer["input_norm"]["scale"])
        sd[f"{p}.post_attention_layernorm.weight"] = w(
            layer["post_attention_norm"]["scale"])
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                            "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            tree = layer["attention" if group == "self_attn" else "mlp"]
            for name in names:
                sd[f"{p}.{group}.{name}.weight"] = w(tree[name]["kernel"].T)
    safetensors_torch.save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": False}))
    with open(assets["tok"], "rb") as f:
        (path / "tokenizer.json").write_bytes(f.read())
    return str(path)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_cli_export_then_serve(hf_checkpoint, tmp_path):
    got, want = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    assert tmain.main(["gguf-export", "--device", "cpu", "--checkpoint",
                       hf_checkpoint, "--gguf", got]) == 0
    assert jmain.main(["gguf-export", "--config",
                       os.path.join(ROOT, "config.yaml"), "--checkpoint",
                       hf_checkpoint, "--gguf", want]) == 0
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()
    payload = {"prompt": PROMPTS[0], "n_predict": 8, "temperature": 0.0}
    local = tg.TextGenerator.from_gguf(got, max_len=2048, device="cpu")
    with LocalGenerationServer(local) as url:
        expected = _post(url + "/completion", payload)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "persian_rag_tpu_torch", "gen-serve",
         "--device", "cpu", "--gguf", got, "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        line = lines.get(timeout=120)
        assert line.startswith("generation server at "), line
        url = line.split()[3]
        assert _post(url + "/completion", payload) == expected
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert expected["content"] == local.generate_text(PROMPTS[0],
                                                      max_tokens=8)


def test_checkpoint_reads_like_jax(hf_checkpoint):
    """gen-serve --checkpoint's loader: the tree and config equal the JAX
    CLI's (params_from_llama over _read_state_dict, DecoderConfig.from_hf)."""
    from persian_rag_tpu.models.hf_loader import _read_state_dict

    tcfg, got = tmain._read_hf_decoder(hf_checkpoint, "cpu")
    with open(os.path.join(hf_checkpoint, "config.json")) as f:
        jcfg = jd.DecoderConfig.from_hf(json.load(f))
    want = jd.params_from_llama(_read_state_dict(hf_checkpoint), jcfg)
    _assert_trees_equal(got, _np_tree(want))
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "num_kv_heads", "intermediate_size", "rope_theta",
                  "tie_word_embeddings"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_cli_refusals(hf_checkpoint, tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("config.json", "model.safetensors"):
        with open(os.path.join(hf_checkpoint, name), "rb") as f:
            (bare / name).write_bytes(f.read())
    assert tmain.main(["gen-serve", "--device", "cpu", "--checkpoint",
                       str(bare)]) == 2
    assert tmain.main(["gguf-export", "--device", "cpu"]) == 2
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 1"):
        tmain.main(["bench"])


@pytest.mark.parametrize("flag", ["--config=x.yaml", "--methods=bm25",
                                  "--force", "--verify"])
def test_cli_refuses_options_of_unported_commands(flag, capsys):
    """Options that only unported commands read are not taken silently."""
    with pytest.raises(SystemExit) as err:
        tmain.build_parser().parse_args(["gen-serve", "--tiny", flag])
    assert err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
