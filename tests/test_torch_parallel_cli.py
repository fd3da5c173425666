"""The port's CLI with a mesh (--mesh-corpus / --mesh-data), on the CPU.

`--device cpu` repeats the CPU device over the mesh, as the JAX CLI's
mesh takes conftest's virtual devices; without `--device` the mesh takes
the CUDA devices and raises without them. `phase3 --tiny` run as a
subprocess on a (2, 2) mesh writes the files a single-device run writes:
the same chunks, and index vectors within 1e-5 (data-parallel encoding).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from persian_rag_tpu_torch import __main__ as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ('models:\n  - "tiny-model"\nchunking:\n  word_chunk_size: 40\n'
          "  word_overlap: 8\n  sentences_per_chunk: 4\n")


def test_mesh_flags_build_the_mesh():
    args = tmain.build_parser().parse_args(
        ["phase3", "--mesh-corpus", "2", "--mesh-data", "2", "--device",
         "cpu"])
    mesh = tmain._mesh(args)
    assert mesh.shape == {"corpus": 2, "data": 2}
    assert mesh.device == torch.device("cpu")
    one = tmain.build_parser().parse_args(["phase3", "--device", "cpu"])
    assert tmain._mesh(one) is None
    if not torch.cuda.is_available():
        cuda = tmain.build_parser().parse_args(["phase3", "--mesh-corpus",
                                                "2"])
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain._mesh(cuda)


def test_cli_phase3_on_a_mesh_equals_single_device(tmp_path, monkeypatch):
    single, sharded = tmp_path / "single", tmp_path / "mesh"
    for d in (single, sharded):
        d.mkdir()
        (d / "config.yaml").write_text(CONFIG, encoding="utf-8")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "persian_rag_tpu_torch", "phase3", "--tiny",
         "--config", "config.yaml", "--device", "cpu", "--mesh-corpus", "2",
         "--mesh-data", "2"],
        cwd=str(sharded), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["success"] is True
    monkeypatch.chdir(single)
    assert tmain.main(["phase3", "--tiny", "--config", "config.yaml",
                       "--device", "cpu"]) == 0
    for name in ("drugs_word_chunks.csv", "drugs_sentence_chunks.csv"):
        assert (single / "data" / "processed" / name).read_bytes() == (
            sharded / "data" / "processed" / name).read_bytes()
    for kind in ("word", "sentence"):
        rel = os.path.join("results", "index", f"drugs_{kind}_chunks.npz")
        want = np.load(single / rel)["vectors"]
        got = np.load(sharded / rel)["vectors"]
        assert got.shape == want.shape and got.shape[0] > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
