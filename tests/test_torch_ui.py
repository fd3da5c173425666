"""The port's web UI against the JAX package's.

`DrugRAGSystem` and the HTTP app (`launch(port=0, block=False)`) of both
packages over the same chunk CSVs, with each package's extractive
`FakeLlamaServer`: the same page, the same /api/init answer, and the same
answers and contexts from /api/ask for tfidf and bm25 (scores within f32
rounding, times masked); the
fall back to the word chunks and the missing-artifact message; and the
corrected fault: the JAX package builds a dense system's encoder with
``tiny=True`` whatever the caller asked, the port takes the caller's.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from persian_rag_tpu.core.config import Config as JaxConfig
from persian_rag_tpu.data.loader import synthetic_persian_qa
from persian_rag_tpu.gen.client import LlamaClient as JaxClient
from persian_rag_tpu.gen.fake_server import FakeLlamaServer as JaxFake
from persian_rag_tpu.pipelines import common as jcommon
from persian_rag_tpu.ui import app as japp

from persian_rag_tpu_torch.core.config import Config, write_csv_records
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.gen.fake_server import FakeLlamaServer
from persian_rag_tpu_torch.pipelines import common as tcommon
from persian_rag_tpu_torch.text.chunking import TextChunker
from persian_rag_tpu_torch.ui import app as tapp

QUESTIONS = ["دارو چیست؟", "کاربرد انسولین شماره 3 در پزشکی چیست؟",
             "عوارض آسپرین", "مصرف قلب باید طبق دستور پزشک باشد"]
TIMES = ("retrieval_time", "generation_time", "total_time", "timing_panel")


def _config(cls, root, kinds=("word", "sentence")):
    cfg = cls()
    cfg.models = ["tiny-model"]
    cfg.chunking.word_chunk_size = 30
    cfg.chunking.word_overlap = 5
    cfg.chunking.sentences_per_chunk = 3
    cfg.generation.server_url = "http://127.0.0.1:9"
    for name in ("data_dir", "raw_dir", "processed_dir", "results_dir",
                 "models_dir", "index_dir", "logs_dir"):
        setattr(cfg.paths, name, os.path.join(str(root),
                                              getattr(cfg.paths, name)))
    os.makedirs(cfg.paths.processed_dir, exist_ok=True)
    text = " ".join(r["context"] for r in synthetic_persian_qa(50, seed=41))
    words, sentences = TextChunker(Config()).process_pdf_document(text)
    for kind, chunks in (("word", words), ("sentence", sentences)):
        if kind in kinds:
            write_csv_records(os.path.join(
                cfg.paths.processed_dir, f"drugs_{kind}_chunks.csv"), chunks)
    return cfg


@pytest.fixture(scope="module")
def servers():
    with JaxFake() as jurl, FakeLlamaServer() as turl:
        yield jurl, turl


def _same_answer(got, want):
    """Equal answers and contexts; scores within f32 rounding (the
    packages sum a lexical score in different orders); times masked."""
    assert got["answer"] == want["answer"]
    assert got["contexts"] == want["contexts"]
    assert set(got) == set(want)
    if "scores" in want:
        assert len(got["scores"]) == len(want["scores"])
        for g, w in zip(got["scores"], want["scores"]):
            assert abs(g - w) <= 1e-6 * max(1.0, abs(w))
    rest = lambda a: {k: v for k, v in a.items()
                      if k not in TIMES + ("scores",)}
    assert rest(got) == rest(want)


@pytest.mark.parametrize("method", ["tfidf", "bm25"])
def test_system_answers_equal(method, servers, tmp_path):
    jurl, turl = servers
    js = japp.DrugRAGSystem(_config(JaxConfig, tmp_path / "j"), method=method)
    ts = tapp.DrugRAGSystem(_config(Config, tmp_path / "t"), method=method,
                            device="cpu")
    assert js.ask_question("x") == ts.ask_question("x")  # not initialised
    assert ts.initialize_system() and js.initialize_system()
    assert ts.init_message == js.init_message
    assert ts.retriever.chunks[0]["chunk_type"] == "sentence_based"
    js.llama, ts.llama = JaxClient(jurl), LlamaClient(turl)
    for question in QUESTIONS:
        for top_k in (1, 5, "7", 40):
            got = ts.ask_question(question, top_k)
            _same_answer(got, js.ask_question(question, top_k))
            assert got["contexts"] and got["answer"] != "پاسخی دریافت نشد"
            assert "زمان بازیابی" in got["timing_panel"]
    assert ts.ask_question("  ") == js.ask_question("  ")


def test_word_fallback_and_missing_artifacts(tmp_path):
    for kinds in (("word",), ()):
        js = japp.DrugRAGSystem(_config(JaxConfig, tmp_path / f"j{len(kinds)}",
                                        kinds))
        ts = tapp.DrugRAGSystem(_config(Config, tmp_path / f"t{len(kinds)}",
                                        kinds), device="cpu")
        assert ts.initialize_system() == js.initialize_system() == bool(kinds)
        assert ts.init_message == js.init_message
        if kinds:
            assert ts.retriever.chunks[0]["chunk_type"] == "word_based"
            assert [c["id"] for c in ts.retriever.chunks] == [
                c["id"] for c in js.retriever.chunks]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(url, data=data, method="POST", headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("method", ["tfidf", "bm25"])
def test_http_endpoints_equal(method, servers, tmp_path):
    jurl, turl = servers
    apps = {}
    for pkg, launch, cls, kw in (("j", japp.launch, JaxConfig, {}),
                                 ("t", tapp.launch, Config,
                                  {"device": "cpu"})):
        server, system = launch(_config(cls, tmp_path / pkg), port=0,
                                method=method, block=False, **kw)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        apps[pkg] = (f"http://127.0.0.1:{server.server_address[1]}", server,
                     system)
    try:
        (jbase, _, jsys), (tbase, _, tsys) = apps["j"], apps["t"]
        assert _get(tbase + "/") == _get(jbase + "/")
        status, page = _get(tbase + "/index.html")
        assert status == 200 and "سیستم پرسش و پاسخ".encode() in page
        assert _get(tbase + "/nope") == _get(jbase + "/nope")
        assert _post(tbase + "/api/ask", {"question": "q"}) == _post(
            jbase + "/api/ask", {"question": "q"})
        init = _post(tbase + "/api/init")
        assert init == _post(jbase + "/api/init")
        assert init == (200, {"ok": True, "message": "سیستم آماده است ✓"})
        jsys.llama, tsys.llama = JaxClient(jurl), LlamaClient(turl)
        for question in QUESTIONS:
            payload = {"question": question, "top_k": 4}
            code, got = _post(tbase + "/api/ask", payload)
            assert code == 200
            contexts, _ = tsys.retriever.get_contexts_for_rag(
                question, top_k=4, max_context_length=3000)
            assert got["contexts"] == contexts
            _same_answer(got, _post(jbase + "/api/ask", payload)[1])
        assert _post(tbase + "/api/nope", {}) == _post(jbase + "/api/nope", {})
    finally:
        for _, server, _ in apps.values():
            server.shutdown()
            server.server_close()


def test_dense_ui_takes_the_callers_tiny(tmp_path, monkeypatch):
    """The JAX UI builds its dense encoder with tiny=True whatever its
    caller asked; the port passes the caller's tiny (False by default,
    so the configured model is built) and device on."""
    calls = {"j": [], "t": []}
    for pkg, module in (("j", jcommon), ("t", tcommon)):
        real = module.build_encoder

        def build(name, config=None, _real=real, _calls=calls[pkg], **kw):
            _calls.append((name, kw))
            return _real(name, config, **kw)
        monkeypatch.setattr(module, "build_encoder", build)
    jcfg = _config(JaxConfig, tmp_path / "j")
    assert japp.DrugRAGSystem(jcfg, method="dense").initialize_system()
    assert calls["j"] == [("tiny-model", {"tiny": True})]
    for tiny in (False, True):
        ts = tapp.DrugRAGSystem(_config(Config, tmp_path / "t"),
                                method="hybrid", tiny=tiny, device="cpu")
        assert ts.initialize_system(), ts.init_message
        assert calls["t"][-1] == ("tiny-model",
                                  {"tiny": tiny, "device": "cpu"})
    # without tiny a preset model is built at its configured width
    tcfg = _config(Config, tmp_path / "t")
    tcfg.models = ["sentence-transformers/paraphrase-multilingual-MiniLM-L12-v2"]
    built = {}
    monkeypatch.setattr(tcommon, "build_encoder",
                        lambda name, config=None, **kw: built.update(kw)
                        or (_ for _ in ()).throw(RuntimeError("stop")))
    ts = tapp.DrugRAGSystem(tcfg, method="dense", device="cpu")
    assert not ts.initialize_system()
    assert built == {"tiny": False, "device": "cpu"}
    assert ts.init_message == "initialization error: stop"
