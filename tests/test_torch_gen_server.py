"""gen/local_server.py and gen/client.py of the port: every route of the
llama.cpp contract, micro-batching of concurrent requests, SSE frames, the
urllib LlamaClient against it, and /rag answered end to end through
RetrievalServer. One greedy answer is held to the JAX package's generator
on the same weights."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from persian_rag_tpu.gen import client as jclient
from persian_rag_tpu.gen import generator as jg
from persian_rag_tpu.models import decoder as jd
from persian_rag_tpu_torch.gen import client as tclient
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.gen.generator import ByteTokenizer, TextGenerator
from persian_rag_tpu_torch.gen.local_server import (
    LocalGenerationServer,
    _PendingGen,
)
from persian_rag_tpu_torch.models.decoder import DecoderConfig
from persian_rag_tpu_torch.retrieval.system import RetrievalSystem
from persian_rag_tpu_torch.serve.api import RetrievalServer


def _post(url, path, payload, timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _post_json(url, path, payload):
    return json.loads(_post(url, path, payload)[2])


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def flax_params():
    return jd.LlamaDecoder(jd.DecoderConfig.tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def served(flax_params):
    tree = jax.tree_util.tree_map(np.asarray, flax_params)
    gen = TextGenerator(DecoderConfig.tiny(), params=tree, max_len=96,
                        device="cpu")
    server = LocalGenerationServer(gen, max_batch=3, max_wait_ms=50.0)
    with server as url:
        yield server, url
    assert server.errors == 0, server.error_log


@pytest.mark.parametrize("path,code", [
    ("/health", 200), ("/v1/models", 200), ("/props", 200), ("/slots", 200),
    ("/completion", 405), ("/chat", 405), ("/v1/chat/completions", 405),
    ("/tokenize", 405), ("/detokenize", 405), ("/embedding", 405),
    ("/v1/embeddings", 405), ("/nothing", 404)])
def test_get_routes(served, path, code):
    server, url = served
    status, body = _get(url, path)
    assert status == code
    if path == "/health":
        assert body == {"status": "ok"}
    if path == "/props":
        assert body["total_slots"] == 3 and body["n_vocab"] == 512
        assert body["default_generation_settings"]["n_ctx"] == 96
        assert body["continuous_batching"] is False
    if path == "/slots":
        assert [s["id"] for s in body] == [0, 1, 2]
        assert all(s["state"] == 0 for s in body)


def test_tokenize_detokenize(served):
    _, url = served
    tok = ByteTokenizer()
    toks = _post_json(url, "/tokenize", {"content": "دارو"})["tokens"]
    assert toks == tok.encode("دارو", add_bos=False)
    with_bos = _post_json(url, "/tokenize",
                          {"content": "دارو", "add_special": True})["tokens"]
    assert with_bos == tok.encode("دارو")
    assert _post_json(url, "/detokenize", {"tokens": toks})["content"] == "دارو"


def test_embeddings(served):
    server, url = served
    emb = np.asarray(
        _post_json(url, "/embedding", {"content": "دارو چیست؟"})["embedding"])
    assert emb.shape == (64,) and abs(np.linalg.norm(emb) - 1.0) < 1e-4
    out = _post_json(url, "/v1/embeddings",
                     {"input": ["دارو چیست؟", "هوا آفتابی است"]})
    assert out["object"] == "list"
    assert [d["index"] for d in out["data"]] == [0, 1]
    np.testing.assert_allclose(np.asarray(out["data"][0]["embedding"]), emb,
                               atol=1e-5)
    assert not np.allclose(np.asarray(out["data"][1]["embedding"]), emb,
                           atol=1e-3)
    one = _post_json(url, "/v1/embeddings", {"input": "دارو چیست؟"})
    assert len(one["data"]) == 1


def test_completion_equals_the_jax_generator(served, flax_params):
    server, url = served
    jgen = jg.TextGenerator(jd.DecoderConfig.tiny(), params=flax_params,
                            max_len=96)
    prompt = "دارو چیست؟ دارو"
    want = jgen.tokenizer.decode(jgen.generate_ids_device(
        jgen.tokenizer.encode(prompt), max_tokens=10))
    got = _post_json(url, "/completion", {"prompt": prompt, "max_tokens": 10})
    assert got == {"content": want}
    # llama.cpp's own spelling of the limit
    n_predict = _post_json(url, "/completion",
                           {"prompt": prompt, "n_predict": 10})
    assert n_predict == got


@pytest.mark.parametrize("path", ["/v1/chat/completions", "/chat"])
def test_chat_routes(served, path):
    _, url = served
    out = _post_json(url, path, {
        "messages": [{"role": "user", "content": "سلام"}], "max_tokens": 6})
    base = _post_json(url, "/completion", {"prompt": "سلام", "max_tokens": 6})
    if path == "/chat":
        assert out == base
    else:
        assert out["choices"][0]["message"] == {
            "role": "assistant", "content": base["content"]}


def test_unknown_post_route(served):
    _, url = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/nothing", {})
    assert e.value.code == 404


def test_penalties_and_sampler_reach_the_generator(served):
    server, url = served
    base = _post_json(url, "/completion", {"prompt": "hi hi hi", "n_predict": 10})
    pen = _post_json(url, "/completion", {"prompt": "hi hi hi", "n_predict": 10,
                                          "repeat_penalty": 5.0})
    assert pen != base
    a = _post_json(url, "/completion", {"prompt": "hi", "n_predict": 10,
                                        "temperature": 0.9, "seed": 7})
    b = _post_json(url, "/completion", {"prompt": "hi", "n_predict": 10,
                                        "temperature": 0.9, "seed": 7})
    assert a == b


def test_concurrent_requests_share_a_batch(served, monkeypatch):
    """Requests that arrive together decode in one generate_batch_device
    call, each answered with its own row (equal to its answer alone)."""
    server, url = served
    prompts = ["دارو چیست؟", "سلام", "هوا آفتابی است"]
    alone = [_post_json(url, "/completion", {"prompt": p, "max_tokens": 8})
             for p in prompts]
    sizes = []
    real = server.generator.generate_batch_device

    def recording(batch, **kw):
        sizes.append(len(batch))
        return real(batch, **kw)

    monkeypatch.setattr(server.generator, "generate_batch_device", recording)
    got = [None] * 3

    def ask(i):
        got[i] = _post_json(url, "/completion",
                            {"prompt": prompts[i], "max_tokens": 8})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert got == alone
    assert max(sizes) >= 2 and sum(sizes) <= 3


def _frames(url, path, payload):
    status, headers, body = _post(url, path, payload)
    assert headers["Content-Type"].startswith("text/event-stream")
    return [f[6:].decode() for f in body.split(b"\n\n") if f.startswith(b"data: ")]


def test_streaming_frames(served):
    _, url = served
    want = _post_json(url, "/completion", {"prompt": "hi", "n_predict": 12})
    objs = [json.loads(f) for f in _frames(
        url, "/completion", {"prompt": "hi", "n_predict": 12, "stream": True})]
    assert objs and objs[-1]["stop"] is True
    assert all(o["stop"] is False for o in objs[:-1])
    assert "".join(o["content"] for o in objs) == want["content"]
    frames = _frames(url, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8,
        "stream": True})
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)


def test_stop_markers():
    p = _PendingGen("x", 8, 0.0, 0.9, ["STOP"], stream=True)
    assert p.push_progress("abc") is False
    assert p.push_progress("abcdeSTOPfg") is True
    assert p.text == "abcde" and p.event.is_set()
    chunks = []
    while not p.chunks.empty():
        chunks.append(p.chunks.get())
    assert chunks == [("abc", False), ("de", True)]
    q = _PendingGen("x", 8, 0.0, 0.9, None)
    q.finish("hello")
    assert q.text == "hello" and q.sampler_key() == (0.0, 0.9, 40, 1.0, 0.0, 0.0, 0)


def test_llama_client_against_the_server(served):
    server, url = served
    client = LlamaClient(url)
    assert client.connected
    info = client.get_server_info()
    assert info["status"] == "connected"
    assert info["endpoints"] == ["/health", "/v1/models", "/completion", "/chat",
                                 "/v1/chat/completions"]
    raw = _post_json(url, "/completion", {
        "prompt": "دارو چیست؟", "max_tokens": 12, "temperature": 0.0,
        "stop": list(tclient.DEFAULT_STOP)})["content"]
    got = client.generate("دارو چیست؟", max_tokens=12, temperature=0.0)
    assert got == (client.clean_prediction(raw.strip()) if raw.strip() else None)
    answers = client.batch_answer(
        [{"question": "دارو چیست؟", "contexts": ["دارو ماده‌ای درمانی است."]}],
        max_tokens=8)
    assert len(answers) == 1 and (answers[0] is None or isinstance(answers[0], str))
    with client as same:
        assert same is client


def test_llama_client_without_a_server_and_fallbacks():
    dead = LlamaClient("http://127.0.0.1:9", timeout=2)
    assert dead.connected is False
    assert dead.generate("x") is None
    assert dead.answer_question("x", ["y"]) is None
    assert dead.get_server_info()["status"] == "disconnected"

    # a server with no /completion: the chat fallbacks answer
    from http.server import BaseHTTPRequestHandler
    from persian_rag_tpu_torch.serve.httpd import BurstHTTPServer

    class ChatOnly(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200 if self.path == "/health" else 404)
            self.end_headers()

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            self.rfile.read(length)
            if self.path != "/chat":
                self.send_response(404)
                self.end_headers()
                return
            body = json.dumps({"response": " پاسخ: این یک پاسخ آزمایشی است "}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = BurstHTTPServer(("127.0.0.1", 0), ChatOnly)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = LlamaClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        assert client.connected
        assert client.generate("x") == client.clean_prediction(
            "پاسخ: این یک پاسخ آزمایشی است")
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("text", [
    "<|eot_id|>assistant پاسخ: تهران پایتخت ایران است. شهر بزرگی است.",
    "", "system: بر اساس اطلاعات ارائه شده، دارو مفید است ...",
    " ".join(["واژه"] * 40)])
def test_client_text_functions_equal_the_jax_package(text):
    ours = LlamaClient("http://127.0.0.1:9", timeout=1)
    theirs = jclient.LlamaClient.__new__(jclient.LlamaClient)
    assert ours.clean_prediction(text) == theirs.clean_prediction(text)
    contexts = ["متن اول " * 30, "متن دوم " * 200, "متن سوم"]
    assert ours.create_rag_prompt("سوال؟", contexts) == theirs.create_rag_prompt(
        "سوال؟", contexts)
    assert tclient.DEFAULT_STOP == jclient.DEFAULT_STOP
    assert tclient.RAG_STOP == jclient.RAG_STOP


def test_rag_answers_through_the_retrieval_server():
    """/rag end to end inside the port: retrieval, the RAG prompt, 128
    sampled tokens from the generation server, the cleaned answer."""
    gen = TextGenerator(DecoderConfig.tiny(max_position_embeddings=1024),
                        max_len=1024, device="cpu", seed=3)
    rs = RetrievalSystem(method="bm25", device="cpu")
    chunks = [{"id": f"c{i}", "text": t, "chunk_type": "t"} for i, t in enumerate(
        ["دارو برای درمان بیماری است", "تهران پایتخت ایران است",
         "ورزش برای سلامت قلب خوب است", "کتاب فصل اول درس زبان فارسی"])]
    assert rs.load_chunks_and_index(chunks)
    server = LocalGenerationServer(gen)
    with server as url:
        with RetrievalServer(rs, llama_client=LlamaClient(url)) as api:
            out = _post_json(api.url, "/rag",
                             {"question": "پایتخت ایران", "top_k": 2})
    assert out["contexts"] and out["question"] == "پایتخت ایران"
    assert out["answer"] is None or isinstance(out["answer"], str)
    assert server.errors == 0, server.error_log
    without = RetrievalServer(rs)
    with without as api:
        assert _post_json(api.url, "/rag", {"question": "دارو"})["answer"] is None


def test_failures_are_counted_not_hidden(flax_params):
    tree = jax.tree_util.tree_map(np.asarray, flax_params)
    gen = TextGenerator(DecoderConfig.tiny(), params=tree, max_len=96,
                        device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    gen.generate_ids_device = broken
    server = LocalGenerationServer(gen)
    with server as url:
        out = _post_json(url, "/completion", {"prompt": "hi", "max_tokens": 4})
    assert out == {"content": ""}  # the contract: an empty answer
    assert server.errors == 1
    assert "kernel launch failed" in server.error_log[0]
