"""In-process fake llama.cpp server for offline tests and demos.

A copy of ``persian_rag_tpu.gen.fake_server`` (the standard library only).
It serves the llama.cpp HTTP contract that ``gen.client.LlamaClient``
speaks (/health, /v1/models, /completion, /v1/chat/completions, /chat)
with a deterministic extractive "model": it answers with the context
sentence that shares the most words with the question. Tests and smoke
runs drive the client's fallback chain and the RAG loop without a model.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler
from typing import List, Optional, Set

from persian_rag_tpu_torch.serve.httpd import BurstHTTPServer


def _extractive_answer(prompt: str) -> str:
    """Pick the context sentence with the highest question-word overlap."""
    question_match = re.search(r"سوال:\s*(.*?)(?:\n|$)", prompt)
    question = question_match.group(1) if question_match else prompt[-200:]
    contexts: List[str] = re.findall(r"متن \d+:\s*(.*?)(?:\n\n|\n|$)", prompt)
    if not contexts:
        contexts = [prompt]
    q_words: Set[str] = set(question.split())
    best_sentence = ""
    best_overlap = -1
    for context in contexts:
        for sentence in re.split(r"[.؟!?]", context):
            sentence = sentence.strip()
            if not sentence:
                continue
            overlap = len(q_words & set(sentence.split()))
            if overlap > best_overlap:
                best_overlap = overlap
                best_sentence = sentence
    return best_sentence or "پاسخی یافت نشد"


class _Handler(BaseHTTPRequestHandler):
    # which endpoints respond; lets tests force the client's fallback chain
    enabled = {"health", "completion", "chat_openai", "chat_simple", "models"}

    def log_message(self, *args):  # silence
        pass

    def _send(self, code: int, payload: Optional[dict] = None):
        body = json.dumps(payload or {}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health" and "health" in self.enabled:
            self._send(200, {"status": "ok"})
        elif self.path == "/v1/models" and "models" in self.enabled:
            self._send(200, {"data": [{"id": "fake-llama"}]})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(length) or b"{}")
        if self.path == "/completion" and "completion" in self.enabled:
            answer = _extractive_answer(data.get("prompt", ""))
            self._send(200, {"content": answer})
        elif (
            self.path == "/v1/chat/completions"
            and "chat_openai" in self.enabled
        ):
            messages = data.get("messages", [])
            prompt = messages[-1]["content"] if messages else ""
            answer = _extractive_answer(prompt)
            self._send(
                200,
                {"choices": [{"message": {"role": "assistant", "content": answer}}]},
            )
        elif self.path == "/chat" and "chat_simple" in self.enabled:
            messages = data.get("messages", [])
            prompt = messages[-1]["content"] if messages else ""
            self._send(200, {"content": _extractive_answer(prompt)})
        else:
            self._send(404, {"error": "not found"})


class FakeLlamaServer:
    """Context manager: with FakeLlamaServer() as url: ..."""

    def __init__(self, enabled: Optional[set] = None, port: int = 0):
        self._handler = type("Handler", (_Handler,), {})
        if enabled is not None:
            self._handler.enabled = enabled
        self._server = BurstHTTPServer(("127.0.0.1", port), self._handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "FakeLlamaServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> str:
        self.start()
        return self.url

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
