"""`python -m persian_rag_tpu_torch serve` / `status` and the CSV chunk
reader, against the JAX package, on the CPU.

* `read_csv_records` gives the records `pd.read_csv(path, encoding="utf-8")
  .to_dict("records")` gives, value for value and type for type (NaN where
  pandas has NaN), on the word and sentence chunk files that the JAX
  `TextChunker.save_chunks` writes and on files at pandas' edges (quoted
  commas, quotes and newlines, NA strings, empty cells in int, float, bool
  and text columns, duplicate and empty header names, short rows, blank
  lines);
* `serve --config ... --device cpu` in a subprocess answers /health and
  /search with the lists of the JAX `RetrievalSystem(method="bm25")` over
  the same CSV (ids equal; scores to 1e-5 relative, the f32 order of the
  sums), and the port's in-process system over the same records;
* `status --config ...` against the port's `FakeLlamaServer` prints what
  the JAX `status` prints against the JAX one (base URLs aside).
"""
import importlib
import json
import math
import os
import re
import subprocess
import sys
import urllib.request

import numpy as np
import pandas as pd
import pytest

from persian_rag_tpu.core.config import Config as JConfig
from persian_rag_tpu.gen.fake_server import FakeLlamaServer as JFake
from persian_rag_tpu.retrieval.system import RetrievalSystem as JSystem
from persian_rag_tpu.text.chunking import TextChunker

tmain = importlib.import_module("persian_rag_tpu_torch.__main__")
tsys = importlib.import_module("persian_rag_tpu_torch.retrieval.system")
tfake = importlib.import_module("persian_rag_tpu_torch.gen.fake_server")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("دارو", "درمان", "بیماری", "قلب", "فشار", "خون", "مصرف", "عوارض",
         "جانبی", "روزانه", "قرص", "کودکان", "NA", "null", "1", "2.5", "True")


def _text(rng, n_words):
    words = list(rng.choice(WORDS, n_words))
    for i in range(9, n_words, 10):
        words[i] += "."
    return " ".join(words)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            a, b = g[key], w[key]
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a), (key, a)
            else:
                assert type(a) is type(b) and a == b, (key, a, b)


@pytest.fixture(scope="module")
def chunk_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("processed")
    config = JConfig()
    config.chunking.word_chunk_size = 40
    config.chunking.word_overlap = 8
    chunker = TextChunker(config)
    rng = np.random.default_rng(0)
    text = _text(rng, 3000)
    chunker.save_chunks(chunker.word_based_chunking(text),
                        "drugs_word_chunks.csv", str(d))
    chunker.save_chunks(chunker.sentence_based_chunking(text),
                        "drugs_sentence_chunks.csv", str(d))
    return d


@pytest.mark.parametrize("name", ["drugs_word_chunks.csv",
                                  "drugs_sentence_chunks.csv"])
def test_chunk_csv_records_equal_pandas(chunk_files, name):
    path = str(chunk_files / name)
    got = tsys.read_csv_records(path)
    want = pd.read_csv(path, encoding="utf-8").to_dict("records")
    assert len(want) > 20
    _same_records(got, want)


EDGE_FILES = {
    "quoting": 'id,text\n1,"a, b"\n2,"say ""hi"""\n3,"two\nlines"\n',
    "na_strings": "id,text\n1,NA\n2,null\n3,\n4,N/A\n5,plain\n",
    "empty_cells": "i,f,b,s\n1,1.5,True,x\n,,,\n3,2e3,False,\n",
    "headers": "a,a,,b\n1,2,3,4\n5,6,7,8\n",
    "short_rows_and_blank_lines": "a,b,c\n1,2,3\n\n4\n5,6\n",
    "numbers": "x,y,z\n+1,-2.5,007\n3,.5,8\n",
    "bools": "p,q\nTRUE,true\nfalse,False\n",
    "header_only": "id,text,num_words\n",
}


@pytest.mark.parametrize("case", sorted(EDGE_FILES))
def test_csv_edges_equal_pandas(tmp_path, case):
    path = tmp_path / f"{case}.csv"
    path.write_text(EDGE_FILES[case], encoding="utf-8")
    _same_records(tsys.read_csv_records(str(path)),
                  pd.read_csv(str(path), encoding="utf-8").to_dict("records"))


def _write_config(path, processed, server_url):
    path.write_text(
        "# a config of the port's serve / status\n"
        "paths:\n"
        f"  processed_dir: \"{processed}\"  # chunk CSVs\n"
        "generation:\n"
        f"  server_url: '{server_url}'\n"
        "retrieval:\n"
        "  methods: [bm25]\n", encoding="utf-8")
    return str(path)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_subprocess_equals_jax_bm25(chunk_files, tmp_path):
    cfg = _write_config(tmp_path / "config.yaml", chunk_files,
                        "http://127.0.0.1:9")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "persian_rag_tpu_torch", "serve", "--config",
         cfg, "--port", "0", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"retrieval API at (http://\S+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        url = m.group(1)
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        rng = np.random.default_rng(1)
        queries = [_text(rng, int(rng.integers(2, 6))) for _ in range(12)]
        served = _post(url + "/search", {"queries": queries, "top_k": 5})
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    csv_path = str(chunk_files / "drugs_word_chunks.csv")
    jrs = JSystem(method="bm25")
    jrs.load_chunks_and_index(csv_path)
    trs = tsys.RetrievalSystem(method="bm25", device="cpu")
    trs.load_chunks_and_index(csv_path)
    for q, hits in zip(queries, served["results"]):
        want = jrs.retrieve(q, top_k=5)
        assert [h["id"] for h in hits] == [c["id"] for c, _ in want]
        np.testing.assert_allclose([h["score"] for h in hits],
                                   [s for _, s in want], rtol=1e-5)
        mine = trs.retrieve(q, top_k=5)
        assert [h["id"] for h in hits] == [c["id"] for c, _ in mine]


def _status(capsys, main, cfg):
    assert main(["status", "--config", cfg]) in (0, None)
    return json.loads(capsys.readouterr().out)


def test_status_equals_jax(chunk_files, tmp_path, capsys):
    from persian_rag_tpu.__main__ import main as jmain

    with tfake.FakeLlamaServer() as t_url, JFake() as j_url:
        t_out = _status(capsys, tmain.main, _write_config(
            tmp_path / "t.yaml", chunk_files, t_url))
        j_out = _status(capsys, jmain, _write_config(
            tmp_path / "j.yaml", chunk_files, j_url))
    assert t_out["server"]["status"] == "connected"
    assert t_out["artifacts"]["drugs_word_chunks.csv"] is True
    for out, url in ((t_out, t_url), (j_out, j_url)):
        assert out["server"].pop("base_url") == url
    assert t_out == j_out
    # no server at the URL: both report it disconnected
    dead = _status(capsys, tmain.main, _write_config(
        tmp_path / "d.yaml", chunk_files, "http://127.0.0.1:9"))
    assert dead["server"]["status"] == "disconnected"
