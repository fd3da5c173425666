"""Retrieval API with request micro-batching.

A JAX-free copy of ``persian_rag_tpu.serve.api`` serving the port's
RetrievalSystem. Concurrent /search requests coalesce into device
batches: a request waits at most ``max_wait_ms`` for co-travelers, then
one ``retrieve_batch`` call at the largest top_k serves the group's
requests of each answer depth (``RetrievalSystem.top_k_depth``: one call
for exact lists, one per top_k for hybrid), so a request's answer does not
depend on its co-travelers up to near-ties (rows whose scores differ by
f32 rounding may swap with the batch: see ``top_k_depth``). (The JAX
server serves a whole group at its largest top_k, so there a hybrid
request's list depends on them.)

Endpoints:
  GET  /health                      -> {"status": "ok", ...}
  POST /search {"queries": [...], "top_k": N}
  POST /rag    {"question": "...", "top_k": N}   (answer is None without
               a client that has ``answer_question(question, contexts)``)
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler
from typing import List, Optional

from persian_rag_tpu_torch.serve.httpd import BurstHTTPServer


class _Pending:
    __slots__ = ("queries", "top_k", "event", "results", "error")

    def __init__(self, queries: List[str], top_k: int):
        self.queries = queries
        self.top_k = top_k
        self.event = threading.Event()
        self.results = None
        self.error: Optional[str] = None


class RetrievalServer:
    def __init__(
        self,
        retriever,
        llama_client=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
    ):
        self.retriever = retriever
        self.llama_client = llama_client
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._batch_loop, daemon=True)
        self.batches_served = 0
        self.requests_served = 0

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload, ensure_ascii=False).encode()
                self.send_response(code)
                self.send_header(
                    "Content-Type", "application/json; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(
                        200,
                        {
                            "status": "ok",
                            "method": outer.retriever.method,
                            "batches_served": outer.batches_served,
                            "requests_served": outer.requests_served,
                        },
                    )
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/search":
                    queries = data.get("queries") or [data.get("query", "")]
                    pending = _Pending(
                        [str(q) for q in queries], int(data.get("top_k", 5))
                    )
                    outer._queue.put(pending)
                    pending.event.wait(timeout=120)
                    if pending.error:
                        self._json(500, {"error": pending.error})
                    else:
                        self._json(200, {"results": pending.results})
                elif self.path == "/rag":
                    question = str(data.get("question", ""))
                    top_k = int(data.get("top_k", 5))
                    contexts, metadata = outer.retriever.get_contexts_for_rag(
                        question, top_k=top_k
                    )
                    answer = None
                    if outer.llama_client is not None:
                        answer = outer.llama_client.answer_question(
                            question, contexts
                        )
                    self._json(
                        200,
                        {
                            "question": question,
                            "contexts": contexts,
                            "metadata": metadata,
                            "answer": answer,
                        },
                    )
                else:
                    self._json(404, {"error": "not found"})

        self._server = BurstHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- batching worker ---------------------------------------------------------

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            total = len(first.queries)
            deadline = self.max_wait_ms / 1000.0
            while total < self.max_batch:
                try:
                    nxt = self._queue.get(timeout=deadline)
                except queue.Empty:
                    break
                group.append(nxt)
                total += len(nxt.queries)
            self._serve_group(group)

    def _serve_group(self, group: List[_Pending]) -> None:
        """One retrieve_batch call per answer depth of the group, in
        arrival order, at that part's largest top_k: a hybrid list (both
        channels over-retrieved at 2 k) or an int8 tier's refine depends
        on the k it is computed at, an exact list only at near-ties. A
        retriever that does not state its depths is served per top_k."""
        depth = getattr(self.retriever, "top_k_depth", lambda k: k)
        parts: dict = {}
        for pending in group:
            parts.setdefault(depth(pending.top_k), []).append(pending)
        for part in parts.values():
            self._serve_part(part, max(p.top_k for p in part))

    def _serve_part(self, group: List[_Pending], top_k: int) -> None:
        queries: List[str] = []
        for pending in group:
            queries.extend(pending.queries)
        try:
            results = self.retriever.retrieve_batch(queries, top_k)
        except Exception as e:  # propagate per request
            for pending in group:
                pending.error = str(e)
                pending.event.set()
            return
        self.batches_served += 1
        cursor = 0
        for pending in group:
            span = results[cursor : cursor + len(pending.queries)]
            cursor += len(pending.queries)
            pending.results = [
                [
                    {
                        "id": chunk["id"],
                        "text": str(chunk["text"]),
                        "score": float(score),
                    }
                    for chunk, score in row[: pending.top_k]
                ]
                for row in span
            ]
            self.requests_served += 1
            pending.event.set()

    # -- lifecycle ----------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "RetrievalServer":
        self._worker.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "RetrievalServer":
        return self.start()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
