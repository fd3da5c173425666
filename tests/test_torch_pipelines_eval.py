"""The port's evaluation pipelines against the JAX package's.

Both packages read the same chunk CSVs (pandas in the JAX package,
`read_csv_records` in the port) and build their encoders from one set of
Flax parameters carried into the port (`build_encoder` monkeypatched in
each pipeline module); generation goes to each package's extractive
`FakeLlamaServer`.

* phase2: `evaluate_model_performance` accuracy equal, cosine within
  1e-5; `main` writes the same files.
* phase4 `main` over both chunk types and the four methods, and
  phase4-enhanced `main`: results, saved JSON and reports equal except
  timestamps and times (the semantic metrics within 1e-5); no chunks ->
  FileNotFoundError in both.
* fast_test: the three checks and the menu equal; the corrected fault
  (an index that cannot be built: the JAX package raises, the port
  reports it).
* The CLI: ``phase4 --tiny --device cpu --methods bm25 --config`` in a
  subprocess, and ``--methods`` refused on every other command.
"""
import glob
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from persian_rag_tpu.core.config import Config as JaxConfig
from persian_rag_tpu.data.loader import synthetic_persian_qa
from persian_rag_tpu.gen.client import LlamaClient as JaxClient
from persian_rag_tpu.gen.fake_server import FakeLlamaServer as JaxFake
from persian_rag_tpu.models.encoder import EncoderConfig as JaxEncConfig
from persian_rag_tpu.models.sentence_encoder import (
    SentenceEncoder as JaxSentenceEncoder,
)
from persian_rag_tpu.pipelines import fast_test as jft
from persian_rag_tpu.pipelines import phase2 as jp2
from persian_rag_tpu.pipelines import phase4 as jp4
from persian_rag_tpu.pipelines import phase4_enhanced as jp4e

from persian_rag_tpu_torch import __main__ as tmain
from persian_rag_tpu_torch.core.config import Config, write_csv_records
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer
from persian_rag_tpu_torch.models.convert import (
    encoder_params_from_flax,
    head_params_from_flax,
)
from persian_rag_tpu_torch.models.encoder import EncoderConfig
from persian_rag_tpu_torch.models.sentence_encoder import SentenceEncoder
from persian_rag_tpu_torch.pipelines import fast_test as tft
from persian_rag_tpu_torch.pipelines import phase2 as tp2
from persian_rag_tpu_torch.pipelines import phase4 as tp4
from persian_rag_tpu_torch.pipelines import phase4_enhanced as tp4e
from persian_rag_tpu_torch.text.chunking import TextChunker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=3000, hidden_size=48, num_layers=2, num_heads=4,
             intermediate_size=96, max_position_embeddings=64)
TEST_ITEMS = synthetic_persian_qa(16, seed=31)


@pytest.fixture(scope="module")
def encoders():
    jenc = JaxSentenceEncoder(JaxEncConfig(**SMALL), max_seq_len=48, seed=2)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(jenc.params))
    tenc = SentenceEncoder(
        EncoderConfig(**SMALL),
        state_dict=encoder_params_from_flax(tree["encoder"]),
        head_state_dict=head_params_from_flax(tree["head"]),
        max_seq_len=48, device="cpu",
    )
    return jenc, tenc


@pytest.fixture(scope="module")
def servers():
    with JaxFake() as jurl, FakeLlamaServer() as turl:
        yield jurl, turl


def _config(cls, root, server_url="http://127.0.0.1:9"):
    cfg = cls()
    cfg.models = ["tiny-model"]
    cfg.evaluation.sample_size = 8
    cfg.chunking.word_chunk_size = 30
    cfg.chunking.word_overlap = 5
    cfg.chunking.sentences_per_chunk = 3
    cfg.generation.server_url = server_url
    for name in ("data_dir", "raw_dir", "processed_dir", "results_dir",
                 "models_dir", "index_dir", "logs_dir"):
        setattr(cfg.paths, name, os.path.join(
            str(root), getattr(cfg.paths, name)))
    return cfg


def _write_chunks(cfg):
    """Word and sentence chunk CSVs of seeded synthetic contexts that
    hold TEST_ITEMS' gold contexts."""
    text = " ".join(r["context"] for r in TEST_ITEMS + synthetic_persian_qa(
        40, seed=32))
    words, sentences = TextChunker(cfg).process_pdf_document(text)
    os.makedirs(cfg.paths.processed_dir, exist_ok=True)
    for kind, chunks in (("word", words), ("sentence", sentences)):
        write_csv_records(os.path.join(
            cfg.paths.processed_dir, f"drugs_{kind}_chunks.csv"), chunks)
    return words, sentences


def _patch(monkeypatch, encoders, *modules_by_pkg):
    jenc, tenc = encoders
    calls = []
    for modules, enc in zip(modules_by_pkg, (jenc, tenc)):
        for module in modules:
            def build(name, config=None, _e=enc, **kw):
                calls.append(kw)
                return _e
            monkeypatch.setattr(module, "build_encoder", build)
    return calls


SEMANTIC = ("semantic_similarity", "answer_relevancy", "cosine_similarity")


def _compare(got, want, path=()):
    """Equal, except where a key names a time (masked) or a cosine metric
    (within 1e-5)."""
    if any("time" in str(p) for p in path) or path[-1:] == ("artifacts",):
        return
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _compare(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, path + (i,))
    elif isinstance(want, float) and any(s in str(p) for p in path
                                         for s in SEMANTIC):
        assert abs(got - want) <= 1e-5, path
    else:
        assert got == want, (path, got, want)


def _report_lines(path):
    """A markdown report without its timestamp and its total-time lines."""
    text = open(path, encoding="utf-8").read()
    text = re.sub(r"#### Total Time\n(?:\d+\..*\n)*", "", text)
    return [line for line in text.splitlines()
            if "Timestamp" not in line and "Total Time" not in line]


def test_phase2_evaluate_model_performance(encoders):
    jenc, tenc = encoders
    data = synthetic_persian_qa(60, seed=3) + synthetic_persian_qa(3, seed=4)
    for kw in ({}, {"sample_size": 20, "n_distractors": 2, "seed": 7},
               {"n_distractors": 70}):  # more distractors than answers
        want = jp2.evaluate_model_performance(jenc, data, **kw)
        got = tp2.evaluate_model_performance(tenc, data, **kw)
        assert got["retrieval_accuracy"] == want["retrieval_accuracy"]
        assert got["num_samples"] == want["num_samples"]
        assert abs(got["cosine_similarity"] - want["cosine_similarity"]) \
            <= 1e-5
    assert tp2.compare_models({"a": got, "b": want}) == jp2.compare_models(
        {"a": got, "b": want})


def test_phase2_main_equal(encoders, tmp_path, monkeypatch):
    calls = _patch(monkeypatch, encoders, [jp2], [tp2])
    data = synthetic_persian_qa(30, seed=5)
    want = jp2.main(_config(JaxConfig, tmp_path / "j"), tiny=True,
                    test_data=data)
    got = tp2.main(_config(Config, tmp_path / "t"), tiny=True,
                   test_data=data, device="cpu")
    _compare(got, want)
    assert calls[1] == {"mesh": None, "tiny": True, "device": "cpu"}
    for name in ("phase2_evaluation_results.json",
                 "phase2_model_comparison.json"):
        j = json.load(open(tmp_path / "j" / "results" / name))
        t = json.load(open(tmp_path / "t" / "results" / name))
        _compare(t, j)
    # test_data.csv in the processed directory is read when present
    for pkg, cfg_cls in (("j", JaxConfig), ("t", Config)):
        cfg = _config(cfg_cls, tmp_path / pkg)
        write_csv_records(os.path.join(cfg.paths.processed_dir,
                                       "test_data.csv"), data[:12])
    want = jp2.main(_config(JaxConfig, tmp_path / "j"), tiny=True)
    got = tp2.main(_config(Config, tmp_path / "t"), tiny=True, device="cpu")
    assert got["models"]["tiny-model"]["num_samples"] == 8
    _compare(got, want)


@pytest.fixture(scope="module")
def phase4_runs(encoders, servers, tmp_path_factory):
    jurl, turl = servers
    mp = pytest.MonkeyPatch()
    _patch(mp, encoders, [jp4], [tp4])
    out = {}
    try:
        for pkg, main, cfg_cls, client, kw in (
                ("jax", jp4.main, JaxConfig, JaxClient(jurl), {}),
                ("torch", tp4.main, Config, LlamaClient(turl),
                 {"device": "cpu"})):
            root = tmp_path_factory.mktemp(pkg)
            cfg = _config(cfg_cls, root)
            _write_chunks(cfg)
            out[pkg] = main(cfg, tiny=True,
                            methods=["bm25", "tfidf", "dense", "hybrid"],
                            test_data=TEST_ITEMS, llama_client=client, **kw)
    finally:
        mp.undo()
    return out


def test_phase4_main_equal(phase4_runs):
    j, t = phase4_runs["jax"], phase4_runs["torch"]
    _compare(t, j)
    assert t["word_dense_results"]["dense_failed_retrievals"] == 0
    assert t["evaluation_metadata"]["chunk_types"] == ["word", "sentence"]
    assert t["sentence_chunks_comparison"]["best_models"]
    assert os.path.basename(t["artifacts"]["json"]).startswith(
        "phase4_rag_evaluation_")
    _compare(json.load(open(t["artifacts"]["json"], encoding="utf-8")),
             json.load(open(j["artifacts"]["json"], encoding="utf-8")))
    assert _report_lines(t["artifacts"]["report"]) == _report_lines(
        j["artifacts"]["report"])


def test_phase4_requires_chunks(tmp_path):
    for main, cls, kw in ((jp4.main, JaxConfig, {}),
                          (tp4.main, Config, {"device": "cpu"})):
        with pytest.raises(FileNotFoundError):
            main(_config(cls, tmp_path / cls.__module__), tiny=True,
                 test_data=TEST_ITEMS[:2], **kw)


def test_phase4_enhanced_main_equal(encoders, servers, tmp_path,
                                    monkeypatch):
    jurl, turl = servers
    calls = _patch(monkeypatch, encoders, [jp4e], [tp4e])
    runs = {}
    for pkg, main, cfg_cls, client, kw in (
            ("j", jp4e.main, JaxConfig, JaxClient(jurl), {}),
            ("t", tp4e.main, Config, LlamaClient(turl), {"device": "cpu"})):
        cfg = _config(cfg_cls, tmp_path / pkg)
        _write_chunks(cfg)
        runs[pkg] = main(cfg, tiny=True, test_data=TEST_ITEMS,
                         llama_client=client, **kw)
    _compare(runs["t"], runs["j"])
    perf = runs["t"]["tiny-model_results"]
    assert perf["tiny-model_relevance_queries"] > 0
    assert perf["tiny-model_recall_at_10"] >= perf["tiny-model_recall_at_1"]
    assert calls[-1] == {"mesh": None, "tiny": True, "device": "cpu"}
    files = {}
    for pkg in ("j", "t"):
        results = str(tmp_path / pkg / "results")
        files[pkg] = (
            glob.glob(results + "/phase4_enhanced_rag_evaluation_*.json"),
            glob.glob(results + "/phase4_enhanced_rag_report_*.md"))
        assert [len(f) for f in files[pkg]] == [1, 1]
    _compare(json.load(open(files["t"][0][0], encoding="utf-8")),
             json.load(open(files["j"][0][0], encoding="utf-8")))
    assert _report_lines(files["t"][1][0]) == _report_lines(files["j"][1][0])


def test_find_relevant_chunks_equal(tmp_path):
    """The port's segment-sum form against the JAX loop, with a chunk of
    stopwords only (no tokens), an item without a context and one whose
    gold tokens the chunks never hold."""
    cfg = _config(Config, tmp_path)
    words, sentences = _write_chunks(cfg)
    items = TEST_ITEMS + [{"question": "q", "context": ""},
                          {"question": "q", "context": "واژه ناشناخته"},
                          {"question": "q", "context": "دارو ناشناخته"}]
    empty = {"id": "empty", "text": "و از در"}
    for chunks in (words, sentences, [empty] + sentences[:20]):
        for threshold in (0.35, 0.2, 0.05):
            got = tp4e.find_relevant_chunks(chunks, items,
                                            threshold=threshold)
            assert got == jp4e.find_relevant_chunks(chunks, items,
                                                    threshold=threshold)
    for chunks in (words, sentences):
        for threshold in (0.35, 0.2):
            got = tp4e.find_relevant_chunks(chunks, TEST_ITEMS,
                                            threshold=threshold)
            assert got == jp4e.find_relevant_chunks(chunks, TEST_ITEMS,
                                                    threshold=threshold)
    assert tp4e.K_GRID == jp4e.K_GRID


def _no_time(d):
    return {k: v for k, v in d.items() if k != "avg_time"}


def test_fast_test_checks_equal(servers, tmp_path):
    jurl, turl = servers
    cfg = _config(Config, tmp_path)
    chunks = _write_chunks(cfg)[0]
    assert tft.SMOKE_QUERIES == jft.SMOKE_QUERIES
    assert tft.LLM_PROMPTS == jft.LLM_PROMPTS
    for method in ("bm25", "tfidf"):
        got = tft.test_retrieval_only(chunks, method=method, device="cpu")
        want = jft.test_retrieval_only(chunks, method=method)
        assert got["passed"] and _no_time(got) == _no_time(want)
    got = tft.test_llama_only(LlamaClient(turl))
    assert got == jft.test_llama_only(JaxClient(jurl))
    assert got["passed"] and got["answered"] == 3
    dead = tft.test_llama_only(LlamaClient("http://127.0.0.1:9"))
    assert dead == jft.test_llama_only(JaxClient("http://127.0.0.1:9"))
    got = tft.test_full_rag_pipeline(chunks, TEST_ITEMS, LlamaClient(turl),
                                     device="cpu")
    want = jft.test_full_rag_pipeline(chunks, TEST_ITEMS, JaxClient(jurl))
    assert got == want and got["passed"] and len(got["questions"]) == 3


def test_fast_test_unbuilt_index(servers, tmp_path):
    """A dense check with no encoder cannot build its index: the JAX
    package ignores that and raises from the unbuilt system, the port
    reports it as `test_retrieval_only` does."""
    jurl, turl = servers
    chunks = _write_chunks(_config(Config, tmp_path))[0]
    with pytest.raises(RuntimeError, match="not ready"):
        jft.test_full_rag_pipeline(chunks, TEST_ITEMS, JaxClient(jurl),
                                   method="dense")
    got = tft.test_full_rag_pipeline(chunks, TEST_ITEMS, LlamaClient(turl),
                                     method="dense", device="cpu")
    assert got == {"passed": False, "error": "index build failed"}
    assert got == tft.test_retrieval_only(chunks, method="dense",
                                          device="cpu")
    assert got == jft.test_retrieval_only(chunks, method="dense")


def test_run_menu_equal(servers, tmp_path, monkeypatch, capsys):
    jurl, turl = servers
    printed = {}
    for pkg, menu, cls, url, kw in (
            ("j", jft.run_menu, JaxConfig, jurl, {}),
            ("t", tft.run_menu, Config, turl, {"device": "cpu"})):
        cfg = _config(cls, tmp_path / pkg, server_url=url)
        _write_chunks(cfg)
        write_csv_records(os.path.join(cfg.paths.processed_dir,
                                       "test_data.csv"), TEST_ITEMS[:4])
        answers = iter(["1", "2", "3", "4", "x", "q"])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
        menu(cfg, **kw)
        out = capsys.readouterr().out
        out = re.sub(r"'avg_time': [0-9.e-]+", "", out)
        printed[pkg] = out.replace(url, "URL")
    assert printed["t"] == printed["j"]
    assert printed["t"].count("'passed': True") == 3


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-m", "persian_rag_tpu_torch", *args], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_phase4(tmp_path):
    cfg = _config(Config, tmp_path)
    _write_chunks(cfg)
    with FakeLlamaServer() as url:
        with open(tmp_path / "config.yaml", "w", encoding="utf-8") as f:
            f.write('models:\n  - "tiny-model"\nevaluation:\n'
                    '  sample_size: 5\ngeneration:\n'
                    f'  server_url: "{url}"\n')
        out = _cli(str(tmp_path), "phase4", "--tiny", "--device", "cpu",
                   "--methods", "bm25", "--config", "config.yaml")
    assert out.returncode == 0, out.stderr
    reports = glob.glob(str(tmp_path / "results" / "phase4_rag_report_*.md"))
    saved = glob.glob(str(tmp_path / "results" /
                          "phase4_rag_evaluation_*.json"))
    assert len(reports) == len(saved) == 1
    report = open(reports[0], encoding="utf-8").read()
    assert "## Best Models for Word Chunks" in report
    assert "## Best Models for Sentence Chunks" in report
    results = json.load(open(saved[0], encoding="utf-8"))
    assert results["evaluation_metadata"]["models_evaluated"] == ["bm25"]
    assert results["evaluation_metadata"]["llm_connectivity"] == "connected"
    for kind in ("word", "sentence"):
        res = results[f"{kind}_bm25_results"]
        assert res["bm25_num_samples"] == 5
        assert res["bm25_failed_retrievals"] == 0
        assert res["bm25_success_rate"] > 0


COMMANDS = ["phase1", "phase2", "phase3", "phase4-enhanced",
            "create-embeddings", "run-all", "fast-test", "status", "ui",
            "serve", "gen-serve", "bench", "gguf-export"]


@pytest.mark.parametrize("command", COMMANDS)
def test_cli_refuses_methods_elsewhere(command, capsys):
    assert set(COMMANDS) | {"phase4"} == set(
        tmain.build_parser()._actions[1].choices)
    with pytest.raises(SystemExit) as err:
        tmain.build_parser().parse_args([command, "--methods", "bm25"])
    assert err.value.code == 2
    assert "--methods bm25 (read by phase4 only)" in capsys.readouterr().err
    ns = tmain.build_parser().parse_args(["phase4", "--methods", "bm25,dense",
                                          "--config", "c.yaml", "--tiny"])
    assert ns.methods == "bm25,dense" and ns.tiny
