"""persian_rag_tpu_torch and chip_smoke.py import neither JAX, flax,
optax, msgpack, pandas, PyYAML, ml_dtypes, requests, tokenizers,
transformers, safetensors, regex, sentencepiece, gradio nor the JAX
package: the machine with the GPU has none of them. Checked in a fresh interpreter, since this test process has
JAX loaded already; importing every module runs nothing (the matvec probe
among them)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import persian_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("ops.sparse_scores", "index.lexical", "ops.hybrid_fusion",
             "index.faiss_io", "ops.quant_matmul", "models.decoder",
             "gen.generator", "gen.local_server", "gen.client",
             "gen.continuous", "scripts.bench_matvec_probe",
             "models.hf_loader", "models.tokenizer_json", "models.gguf",
             "ops.lexical_prefilter", "native", "core.config",
             "gen.fake_server", "utils.timing", "utils.logging",
             "pipelines.fast_test", "__main__", "index.ivf",
             "index.collections", "text.persian", "text.pdf",
             "text.chunking", "data.loader", "pipelines.common",
             "pipelines.create_embeddings", "pipelines.phase3",
             "eval", "eval.metrics", "eval.evaluator", "ui", "ui.app",
             "pipelines.phase2", "pipelines.phase4",
             "pipelines.phase4_enhanced", "train", "train.trainer",
             "train.lora", "models.flax_msgpack", "pipelines.phase1",
             "pipelines.run_all", "core.mesh", "parallel",
             "parallel.sharded_search", "parallel.sharded_lexical",
             "parallel.sharded_ivf", "parallel.tp", "parallel.tp_decoder"):
    assert pkg.__name__ + "." + name in names, name
import chip_smoke
import torch
assert not torch.cuda.is_initialized()
banned = ("jax", "jaxlib", "flax", "pandas", "yaml", "ml_dtypes", "requests",
          "persian_rag_tpu", "tokenizers", "transformers", "safetensors",
          "regex", "sentencepiece", "gradio", "optax", "msgpack")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), loaded)
assert not loaded, loaded
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # importing runs nothing: the probe prints only when it runs
    assert len(out.stdout.splitlines()) == 1, out.stdout
    n_modules, loaded = out.stdout.split(" ", 1)
    assert int(n_modules) >= 25 and loaded.strip() == "[]"
