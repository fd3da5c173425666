"""Web UI for interactive Persian drug QA.

The counterpart of ``persian_rag_tpu.ui.app``: `DrugRAGSystem`
(initialisation from the chunk CSVs with a self-test, and the ask flow:
top_k held to 3-10, a 3,000-character context budget, Persian timing
panel) and `launch`, a standard-library HTTP app on `BurstHTTPServer`
serving the same right-to-left page at ``GET /`` with ``POST /api/init``
and ``POST /api/ask``, on 127.0.0.1:7860 by default. The method defaults
to tfidf over the sentence chunks, falling back to the word chunks.
Retrieval lives on `device` (None: the card).

One chosen divergence: a dense or hybrid system builds its encoder with
the caller's `tiny` (the CLI's ``--tiny``), so without it the configured
``config.models[0]`` is built as every other command builds it; the JAX
package always builds the small random encoder here.
"""
from __future__ import annotations

import json
import os
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional

from persian_rag_tpu_torch.core.config import Config
from persian_rag_tpu_torch.gen.client import LlamaClient
from persian_rag_tpu_torch.retrieval.system import (
    RetrievalSystem,
    read_csv_records,
)
from persian_rag_tpu_torch.serve.httpd import BurstHTTPServer

CHUNK_TYPE = "sentence"
SELF_TEST_QUERY = "دارو چیست؟"


class DrugRAGSystem:
    """Initialisation and the ask flow."""

    def __init__(self, config: Optional[Config] = None, method: str = "tfidf",
                 tiny: bool = False, device=None):
        self.config = config or Config()
        self.method = method
        self.tiny = tiny
        self.device = device
        self.retriever: Optional[RetrievalSystem] = None
        self.llama: Optional[LlamaClient] = None
        self.initialized = False
        self.init_message = ""

    def initialize_system(self, chunks=None) -> bool:
        config = self.config
        try:
            if chunks is None:
                chunk_csv = os.path.join(
                    config.paths.processed_dir,
                    f"drugs_{CHUNK_TYPE}_chunks.csv",
                )
                if not os.path.exists(chunk_csv):
                    chunk_csv = os.path.join(
                        config.paths.processed_dir, "drugs_word_chunks.csv"
                    )
                if not os.path.exists(chunk_csv):
                    self.init_message = "chunk artifacts missing — run phase3"
                    return False
                chunks = read_csv_records(chunk_csv)
            self.llama = LlamaClient(config.generation.server_url)
            encoder = None
            if self.method in ("dense", "hybrid"):
                from persian_rag_tpu_torch.pipelines.common import (
                    build_encoder,
                )

                encoder = build_encoder(config.models[0], config,
                                        tiny=self.tiny, device=self.device)
            self.retriever = RetrievalSystem(method=self.method,
                                             encoder=encoder,
                                             device=self.device)
            if not self.retriever.load_chunks_and_index(chunks):
                self.init_message = "index build failed"
                return False
            # end-to-end self test
            contexts, _ = self.retriever.get_contexts_for_rag(
                SELF_TEST_QUERY, top_k=3
            )
            self.initialized = bool(contexts)
            self.init_message = (
                "سیستم آماده است ✓" if self.initialized else "self-test failed"
            )
            return self.initialized
        except Exception as e:
            self.init_message = f"initialization error: {e}"
            return False

    def ask_question(self, question: str, top_k: int = 5) -> Dict:
        if not self.initialized:
            return {"error": "system not initialized", "answer": ""}
        if not question or not question.strip():
            return {"error": "لطفا سوال خود را وارد کنید", "answer": ""}
        top_k = max(3, min(int(top_k), 10))

        t0 = time.time()
        contexts, metadata = self.retriever.get_contexts_for_rag(
            question, top_k=top_k, max_context_length=3000
        )
        retrieval_time = time.time() - t0

        t0 = time.time()
        answer = None
        if self.llama and self.llama.connected:
            answer = self.llama.answer_question(question, contexts)
        generation_time = time.time() - t0

        return {
            "answer": answer or "پاسخی دریافت نشد",
            "contexts": contexts,
            "scores": [m["score"] for m in metadata],
            "retrieval_time": retrieval_time,
            "generation_time": generation_time,
            "total_time": retrieval_time + generation_time,
            "timing_panel": (
                f"زمان بازیابی: {retrieval_time:.3f} ثانیه | "
                f"زمان تولید: {generation_time:.2f} ثانیه"
            ),
        }


_PAGE = """<!DOCTYPE html>
<html dir="rtl" lang="fa"><head><meta charset="utf-8">
<title>سیستم پرسش و پاسخ دارویی</title>
<style>
 body{font-family:Tahoma,sans-serif;max-width:760px;margin:2rem auto;
      background:#f7f7f9;color:#222;padding:0 1rem}
 h1{font-size:1.4rem} textarea,input{width:100%;padding:.5rem;font-size:1rem}
 button{padding:.5rem 1.4rem;font-size:1rem;margin:.5rem 0;cursor:pointer}
 .panel{background:#fff;border:1px solid #ddd;border-radius:8px;
        padding:1rem;margin:.7rem 0;white-space:pre-wrap}
 .dim{color:#777;font-size:.85rem}
</style></head><body>
<h1>💊 سیستم پرسش و پاسخ دارویی (TPU-native)</h1>
<button id="init">راه‌اندازی سیستم</button><span id="initmsg" class="dim"></span>
<div><textarea id="q" rows="2" placeholder="سوال خود را بنویسید..."></textarea>
<label class="dim">تعداد متن بازیابی: <input id="k" type="number" min="3" max="10" value="5" style="width:5rem"></label>
<button id="ask" disabled>بپرس</button></div>
<div id="answer" class="panel" hidden></div>
<div id="timing" class="dim"></div>
<div id="ctx" class="panel dim" hidden></div>
<script>
const $=id=>document.getElementById(id);
$('init').onclick=async()=>{ $('initmsg').textContent='...';
 const r=await fetch('/api/init',{method:'POST'}); const d=await r.json();
 $('initmsg').textContent=d.message; $('ask').disabled=!d.ok; };
$('ask').onclick=async()=>{ $('answer').hidden=false; $('answer').textContent='...';
 const r=await fetch('/api/ask',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({question:$('q').value,top_k:+$('k').value})});
 const d=await r.json();
 $('answer').textContent=d.answer||d.error||'';
 $('timing').textContent=d.timing_panel||'';
 if(d.contexts){ $('ctx').hidden=false;
   $('ctx').textContent=d.contexts.map((c,i)=>`متن ${i+1}: ${c}`).join('\\n\\n'); }};
</script></body></html>"""


def launch(
    config: Optional[Config] = None,
    host: str = "127.0.0.1",
    port: int = 7860,
    method: str = "tfidf",
    block: bool = True,
    tiny: bool = False,
    device=None,
):
    """Serve the UI on host:port (0 picks a free port). block=False
    returns (server, system) without serving: the caller runs
    ``server.serve_forever()`` (in a thread) and ``server.shutdown()``."""
    system = DrugRAGSystem(config, method=method, tiny=tiny, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/api/init":
                ok = system.initialize_system()
                self._json(200, {"ok": ok, "message": system.init_message})
            elif self.path == "/api/ask":
                self._json(
                    200,
                    system.ask_question(
                        data.get("question", ""), data.get("top_k", 5)
                    ),
                )
            else:
                self._json(404, {"error": "not found"})

    server = BurstHTTPServer((host, port), Handler)
    print(f"UI at http://{host}:{server.server_address[1]}", flush=True)
    if block:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.server_close()
    return server, system
