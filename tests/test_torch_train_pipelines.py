"""pipelines/phase1.py and pipelines/run_all.py of the port against the
JAX package's, on the CPU, and the ``phase1`` / ``run-all`` commands.

`main` of each package's phase1 runs with `build_encoder` monkeypatched
to encoders that carry the same weights (the JAX one, converted for the
port). The JAX `load_datasets` is monkeypatched to what it returns
offline, (None, None): it would try the hub, and the port's raises. Both
phases then train on `synthetic_persian_qa()`: the CSVs are byte-equal,
the results JSON has the same keys and values (times aside; the logged
loss within 1e-5), and the fine-tuned parameters agree within 1e-5.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from persian_rag_tpu.core.config import Config as JaxConfig
from persian_rag_tpu.data.loader import DataLoader as JaxLoader
from persian_rag_tpu.models.encoder import EncoderConfig as JaxEncConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.pipelines import phase1 as jp1
from persian_rag_tpu.train.trainer import EmbeddingTrainer as JaxTrainer

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
    params_to_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.pipelines import common as tcommon
from persian_rag_tpu_torch.pipelines import phase1 as tp1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_position_embeddings=64)
MODEL_KEYS = ["training_examples", "training_time", "samples_per_second",
              "final_loss", "model_path"]


def _config(cls, root):
    cfg = cls()
    cfg.models = ["tiny-model"]
    cfg.training.max_train_samples = 120
    for name in ("data_dir", "raw_dir", "processed_dir", "results_dir",
                 "models_dir", "index_dir", "logs_dir"):
        setattr(cfg.paths, name, os.path.join(str(root),
                                              getattr(cfg.paths, name)))
    return cfg


def _carried():
    jenc = JaxSentenceEncoder(JaxEncConfig(**SMALL), max_seq_len=32, seed=4)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        max_seq_len=32, device="cpu")
    return jenc, tenc


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.array(value)
    return out


def test_phase1_main_equal_jax(tmp_path, monkeypatch):
    jenc, tenc = _carried()
    calls = []
    for module, enc in ((jp1, jenc), (tp1, tenc)):
        def build(name, config=None, _e=enc, **kw):
            calls.append(kw)
            return _e
        monkeypatch.setattr(module, "build_encoder", build)
    monkeypatch.setattr(JaxLoader, "load_datasets", lambda self: (None, None))
    jcfg, tcfg = _config(JaxConfig, tmp_path / "jax"), _config(
        Config, tmp_path / "port")
    want = jp1.main(jcfg, tiny=True)
    got = tp1.main(tcfg, tiny=True, device="cpu")
    assert calls[1] == {"mesh": None, "tiny": True, "device": "cpu"}

    assert list(got) == list(want) == ["total_qa_pairs", "train_size",
                                       "test_size", "models"]
    assert [got[k] for k in list(got)[:3]] == [want[k] for k in
                                               list(want)[:3]] == [120, 108, 12]
    g, w = got["models"]["tiny-model"], want["models"]["tiny-model"]
    assert list(g) == list(w) == MODEL_KEYS
    assert g["training_examples"] == w["training_examples"]
    assert abs(g["final_loss"] - w["final_loss"]) < 1e-5
    assert os.path.relpath(g["model_path"], tmp_path / "port") == (
        os.path.relpath(w["model_path"], tmp_path / "jax"))
    for name in ("train_data.csv", "test_data.csv"):
        assert (tmp_path / "port" / "data" / "processed" / name).read_bytes(
        ) == (tmp_path / "jax" / "data" / "processed" / name).read_bytes()
    saved = json.loads((tmp_path / "port" / "results" /
                        "phase1_training_results.json").read_text("utf-8"))
    assert saved == json.loads(json.dumps(got))

    # the fine-tuned files: each package reads the other's
    want_params = _flat(JaxTrainer.load_model(w["model_path"]).params)
    port_enc = tcommon.build_encoder("tiny-model", tcfg, device="cpu")
    got_params = _flat({"encoder": params_to_flax(port_enc.encoder),
                        "head": params_to_flax(port_enc.head)})
    assert sorted(got_params) == sorted(want_params)
    for key in want_params:
        np.testing.assert_allclose(got_params[key], want_params[key],
                                   rtol=0, atol=1e-5, err_msg=key)
    jax_read = _flat(JaxTrainer.load_model(g["model_path"]).params)
    for key in want_params:
        np.testing.assert_array_equal(jax_read[key], got_params[key])


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-m", "persian_rag_tpu_torch", *args,
         "--config", "config.yaml", "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_phase1(tmp_path):
    (tmp_path / "config.yaml").write_text(
        'models:\n  - "tiny-model"\n  - "intfloat/multilingual-e5-base"\n'
        "training:\n  max_train_samples: 60\n", encoding="utf-8")
    out = _cli(str(tmp_path), "phase1", "--tiny")
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout)
    assert list(result) == ["total_qa_pairs", "train_size", "test_size",
                            "models"]
    assert (result["total_qa_pairs"], result["train_size"]) == (60, 54)
    cfg = Config()
    cfg.paths.models_dir = str(tmp_path / "models")
    for name, model in result["models"].items():
        assert list(model) == MODEL_KEYS
        assert model["model_path"] == os.path.join(
            "models", tcommon.short_name(name) + "_finetuned")
        enc = tcommon.build_encoder(name, cfg, device="cpu")
        assert enc.config == tcommon.TINY_PRESET  # --tiny, then fine-tuned
        assert np.isfinite(enc.encode(["دارو برای درمان"])).all()
    assert (tmp_path / "results" / "phase1_training_results.json").exists()


def test_cli_run_all(tmp_path):
    with FakeLlamaServer() as url:
        (tmp_path / "config.yaml").write_text(
            'models:\n  - "tiny-model"\ntraining:\n  max_train_samples: 60\n'
            "evaluation:\n  sample_size: 5\ngeneration:\n"
            f'  server_url: "{url}"\n', encoding="utf-8")
        out = _cli(str(tmp_path), "run-all", "--tiny")
    assert out.returncode == 0, out.stderr
    # the CLI prints the results JSON cut at 4,000 characters, as the JAX
    # CLI does: phase4's part may fall past the cut, its files may not
    for phase in ("phase1", "phase2", "phase3"):
        assert f'\n  "{phase}": {{' in out.stdout, phase
    results = tmp_path / "results"
    phase1 = json.loads((results / "phase1_training_results.json")
                        .read_text("utf-8"))
    assert phase1["models"]["tiny-model"]["training_examples"] > 0
    assert (results / "phase2_evaluation_results.json").exists()
    assert json.loads((results / "phase3_pdf_processing_results.json")
                      .read_text("utf-8"))["success"] is True
    (report,) = results.glob("phase4_rag_evaluation_*.json")
    meta = json.loads(report.read_text("utf-8"))["evaluation_metadata"]
    assert meta["llm_connectivity"] == "connected"
    assert (tmp_path / "models" / "tiny-model_finetuned" /
            "params.msgpack").exists()


@pytest.mark.parametrize("command", ["phase1", "run-all"])
def test_cli_takes_config_and_refuses_a_mesh(command, tmp_path):
    from persian_rag_tpu_torch import __main__ as tmain

    ns = tmain.build_parser().parse_args([command, "--tiny", "--config",
                                          "c.yaml"])
    assert ns.tiny and ns.config == "c.yaml"
    assert command not in tmain._UNPORTED
    # the mesh is ported (tests/test_torch_parallel_cli.py): without
    # --device it takes the CUDA devices, and raises without them
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain.main([command, "--mesh-data", "2"])
