"""Local generation server: the PyTorch decoder behind the llama.cpp contract.

The counterpart of ``persian_rag_tpu.gen.local_server``: serves /health,
/v1/models, /completion, /v1/chat/completions and /chat from a
TextGenerator, so LlamaClient (and everything above it) runs against an
in-process model on the card. The rest of the llama.cpp server surface is
covered too: /tokenize, /detokenize, /embedding (+ OpenAI /v1/embeddings)
from the decoder's mean-pooled hidden states, /props and /slots.

Two schedulers: static micro-batching and, with ``continuous=True``,
llama.cpp's slot scheduler (gen/continuous.ContinuousBatcher). A failed
group or decode segment still answers "" to each of its requests (the
contract), but the failure is counted in ``errors`` and its traceback kept
in ``error_log``: a kernel that does not launch must not pass for an empty
answer.
"""
from __future__ import annotations

import json
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler
from typing import List, Optional

from persian_rag_tpu_torch.gen.continuous import ContinuousBatcher
from persian_rag_tpu_torch.gen.generator import TextGenerator
from persian_rag_tpu_torch.serve.httpd import BurstHTTPServer


class _PendingGen:
    __slots__ = ("prompt", "max_tokens", "temperature", "top_p", "top_k",
                 "stop", "repeat_penalty", "frequency_penalty",
                 "presence_penalty", "seed", "stream", "chunks", "sent",
                 "event", "text")

    def __init__(self, prompt, max_tokens, temperature, top_p, stop,
                 top_k=40, repeat_penalty=1.0, frequency_penalty=0.0,
                 presence_penalty=0.0, seed=0, stream=False):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.stop = stop
        self.repeat_penalty = repeat_penalty
        self.frequency_penalty = frequency_penalty
        self.presence_penalty = presence_penalty
        self.seed = seed
        self.stream = stream
        # streaming: worker pushes (delta_text, is_last); handler drains
        self.chunks: "queue.Queue" = queue.Queue()
        self.sent = ""  # cumulative text already pushed to the client
        self.event = threading.Event()
        self.text: Optional[str] = None

    def push_progress(self, full_text: str) -> bool:
        """Emit the new suffix of ``full_text`` as a stream chunk,
        honoring stop markers across chunk boundaries (llama.cpp scans
        the whole generated text, not each chunk). Returns True when a
        stop marker fired — the caller should finish the request."""
        for marker in self.stop or []:
            idx = full_text.find(marker)
            if idx >= 0:
                self.finish(full_text[:idx])
                return True
        # hold back a partial trailing replacement char (a UTF-8
        # sequence split across token boundaries decodes to U+FFFD
        # until its continuation tokens arrive)
        stable = full_text.rstrip("�")
        if len(stable) > len(self.sent):
            delta = stable[len(self.sent):]
            self.sent = stable
            if self.stream:
                self.chunks.put((delta, False))
        return False

    def finish(self, full_text: str) -> None:
        for marker in self.stop or []:
            idx = full_text.find(marker)
            if idx >= 0:
                full_text = full_text[:idx]
        self.text = full_text
        if self.stream:
            delta = (
                full_text[len(self.sent):]
                if full_text.startswith(self.sent)
                else full_text
            )
            self.chunks.put((delta, True))
        self.event.set()

    def sampler_key(self):
        """Requests batch together only when every device-side sampler
        parameter matches (they are per-call, not per-row)."""
        return (self.temperature, self.top_p, self.top_k,
                self.repeat_penalty, self.frequency_penalty,
                self.presence_penalty, self.seed)


class LocalGenerationServer:
    """Serves generation over the llama.cpp HTTP contract.

    - static micro-batching (default): a request waits up to
      ``max_wait_ms`` for co-travelers, then the whole group decodes in one
      batched loop (TextGenerator.generate_batch_device). A long answer
      blocks its group, and late arrivals wait for the group barrier. A
      lone request, or a group with mixed sampler settings, decodes request
      by request (greedy ones through the speculative loop).
    - ``continuous=True``: llama.cpp's slot scheduler. A ``max_batch``-row
      decode batch stays resident on the card and finished rows swap for
      queued prompts between segments of ``segment`` forwards
      (gen/continuous.ContinuousBatcher, ``speculative`` False / True /
      "auto"). Per-request temperature, top_p and penalties are honoured
      per row; ``top_k`` is the batcher's (llama.cpp's default 40).
    """

    def __init__(
        self,
        generator: TextGenerator,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        continuous: bool = False,
        segment: int = 32,
        speculative=False,
    ):
        self.generator = generator
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.segment = segment
        self.speculative = speculative
        self._queue: "queue.Queue[_PendingGen]" = queue.Queue()
        self._stop = threading.Event()
        # groups or segments whose generation raised, and their tracebacks
        self.errors = 0
        self.error_log: List[str] = []
        # static-mode slot observability: requests currently being decoded
        # by the batch worker (single writer: the worker thread; handler
        # threads only read it for GET /slots)
        self._active = 0
        self._batcher = self._new_batcher() if continuous else None
        self._worker = threading.Thread(
            target=self._continuous_loop if continuous else self._batch_loop,
            daemon=True)
        self._worker.start()
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
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._json(
                        200, {"data": [{"id": "persian-rag-tpu-decoder"}]}
                    )
                elif self.path == "/props":
                    # llama.cpp server properties: defaults + slot count
                    cfg = outer.generator.config
                    self._json(
                        200,
                        {
                            "total_slots": outer.max_batch,
                            "model_path": "persian-rag-tpu-decoder",
                            "default_generation_settings": {
                                "n_ctx": outer.generator.max_len,
                                "n_predict": 128,
                                "temperature": 0.0,
                                "top_k": 40,
                                "top_p": 0.9,
                                "repeat_penalty": 1.0,
                                "stream": False,
                            },
                            "n_vocab": cfg.vocab_size,
                            "continuous_batching": outer._batcher is not None,
                        },
                    )
                elif self.path == "/slots":
                    # llama.cpp slot states: 0 idle, 1 processing. In
                    # continuous mode the batcher rows are the slots;
                    # static micro-batching reports the in-flight group.
                    batcher = outer._batcher
                    if batcher is not None:
                        slots = [
                            {"id": i, "state": 0} if req is None else
                            {"id": i, "state": 1, "req_id": req.req_id}
                            for i, req in enumerate(list(batcher._rows))
                        ]
                    else:
                        busy = min(outer._active, outer.max_batch)
                        slots = [{"id": i, "state": 1 if i < busy else 0}
                                 for i in range(outer.max_batch)]
                    self._json(200, slots)
                elif self.path in (
                    "/completion", "/chat", "/v1/chat/completions",
                    "/tokenize", "/detokenize", "/embedding",
                    "/v1/embeddings",
                ):
                    # POST-only endpoints answer GET probes with 405, the
                    # llama.cpp behavior get_server_info relies on
                    self._json(405, {"error": "method not allowed"})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(length) or b"{}")
                tokenizer = outer.generator.tokenizer
                if self.path == "/tokenize":
                    # llama.cpp contract: add_special defaults to false
                    # (no BOS) — our tokenizers default add_bos=True,
                    # so thread the flag through where supported
                    text = data.get("content", "")
                    add_special = bool(data.get("add_special", False))
                    try:
                        tokens = tokenizer.encode(
                            text, add_bos=add_special
                        )
                    except TypeError:  # tokenizer without a BOS concept
                        tokens = tokenizer.encode(text)
                    self._json(200, {"tokens": [int(t) for t in tokens]})
                    return
                if self.path == "/detokenize":
                    tokens = [int(t) for t in data.get("tokens", [])]
                    self._json(200, {"content": tokenizer.decode(tokens)})
                    return
                if self.path == "/embedding":
                    # llama.cpp --embedding serving: mean-pooled
                    # final-norm hidden states, L2-normalized
                    emb = outer.generator.embed_text(
                        [data.get("content", "")]
                    )
                    self._json(
                        200, {"embedding": [float(v) for v in emb[0]]}
                    )
                    return
                if self.path == "/v1/embeddings":
                    inputs = data.get("input", "")
                    if isinstance(inputs, str):
                        inputs = [inputs]
                    emb = outer.generator.embed_text(inputs)
                    self._json(
                        200,
                        {
                            "object": "list",
                            "model": data.get(
                                "model", "persian-rag-tpu-decoder"
                            ),
                            "data": [
                                {
                                    "object": "embedding",
                                    "index": i,
                                    "embedding": [float(v) for v in row],
                                }
                                for i, row in enumerate(emb)
                            ],
                        },
                    )
                    return
                if self.path == "/completion":
                    prompt = data.get("prompt", "")
                elif self.path in ("/v1/chat/completions", "/chat"):
                    messages = data.get("messages", [])
                    prompt = messages[-1]["content"] if messages else ""
                else:
                    self._json(404, {"error": "not found"})
                    return
                # llama.cpp also spells max_tokens as n_predict
                max_tokens = data.get("max_tokens",
                                      data.get("n_predict", 128))
                # llama.cpp penalty chain. Server default is MODERN
                # llama.cpp's repeat_penalty=1.0 (older builds shipped
                # 1.1); clients wanting the legacy behavior pass it
                # explicitly. seed=-1 (llama.cpp "random") maps to 0.
                seed = int(data.get("seed", 0))
                stream = bool(data.get("stream", False))
                pending = _PendingGen(
                    prompt,
                    int(max_tokens),
                    float(data.get("temperature", 0.0)),
                    float(data.get("top_p", 0.9)),
                    data.get("stop"),
                    top_k=int(data.get("top_k", 40)),
                    repeat_penalty=float(data.get("repeat_penalty", 1.0)),
                    frequency_penalty=float(
                        data.get("frequency_penalty", 0.0)
                    ),
                    presence_penalty=float(
                        data.get("presence_penalty", 0.0)
                    ),
                    seed=max(seed, 0),
                    stream=stream,
                )
                outer._queue.put(pending)
                if stream:
                    self._stream_response(pending)
                    return
                pending.event.wait(timeout=600)
                text = pending.text or ""
                if self.path == "/completion":
                    self._json(200, {"content": text})
                elif self.path == "/v1/chat/completions":
                    self._json(
                        200,
                        {
                            "choices": [
                                {
                                    "message": {
                                        "role": "assistant",
                                        "content": text,
                                    }
                                }
                            ]
                        },
                    )
                else:
                    self._json(200, {"content": text})

            def _stream_response(self, pending) -> None:
                """Server-sent events. /completion frames follow
                llama.cpp ({"content": ..., "stop": bool} per chunk);
                /v1/chat/completions follows the OpenAI delta format
                with a final ``data: [DONE]`` sentinel. The static
                scheduler streams one chunk per finished answer; the continuous
                one a chunk per decode segment."""
                chat = self.path == "/v1/chat/completions"
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/event-stream; charset=utf-8"
                )
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def frame(obj):
                    self.wfile.write(
                        b"data: "
                        + json.dumps(obj, ensure_ascii=False).encode()
                        + b"\n\n"
                    )
                    self.wfile.flush()

                while True:
                    try:
                        delta, last = pending.chunks.get(timeout=600)
                    except queue.Empty:
                        delta, last = "", True
                    if chat:
                        choice = {"index": 0, "delta": {}}
                        if delta:
                            choice["delta"] = {"content": delta}
                        if last:
                            choice["finish_reason"] = "stop"
                        frame({"object": "chat.completion.chunk",
                               "choices": [choice]})
                    else:
                        frame({"content": delta, "stop": bool(last)})
                    if last:
                        if chat:
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                        return

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
            while len(group) < self.max_batch:
                try:
                    group.append(
                        self._queue.get(timeout=self.max_wait_ms / 1000.0)
                    )
                except queue.Empty:
                    break
            self._active = len(group)
            self._serve_group(group)
            self._active = 0

    def _new_batcher(self) -> ContinuousBatcher:
        return ContinuousBatcher(
            self.generator, batch=self.max_batch, segment=self.segment,
            speculative=self.speculative)

    def _continuous_loop(self) -> None:
        """Worker of continuous mode: feed arrivals into the resident decode
        batch between segments, stream progress, finish requests as they
        land."""
        tokenizer = self.generator.tokenizer
        inflight = {}
        while not self._stop.is_set():
            # drain arrivals; block briefly only when fully idle
            block = self._batcher.idle() and not inflight
            while True:
                try:
                    p = self._queue.get(timeout=0.05 if block else 0.0)
                except queue.Empty:
                    break
                block = False
                rid = self._batcher.submit(
                    tokenizer.encode(p.prompt),
                    max_tokens=p.max_tokens,
                    temperature=p.temperature,
                    top_p=p.top_p,
                    repeat_penalty=p.repeat_penalty,
                    frequency_penalty=p.frequency_penalty,
                    presence_penalty=p.presence_penalty,
                )
                inflight[rid] = p
            if self._batcher.idle():
                continue
            try:
                self._batcher.step()
                finished = self._batcher.finished()
                # stream partials of still-running rows; a stop marker
                # finishes the request early and frees its slot
                for rid, pending in list(inflight.items()):
                    req = self._batcher.request(rid)
                    if req is None or not req.tokens:
                        continue
                    text = tokenizer.decode(req.tokens[: pending.max_tokens])
                    if pending.push_progress(text):
                        self._batcher.cancel(rid)
                        del inflight[rid]
            except Exception:
                self.errors += 1
                self.error_log.append(traceback.format_exc())
                for pending in inflight.values():
                    pending.finish("")
                inflight.clear()
                # a failed segment may leave the batcher's state half
                # updated: later requests get a fresh scheduler
                self._batcher = self._new_batcher()
                continue
            for req in finished:
                pending = inflight.pop(req.req_id, None)
                if pending is not None:
                    pending.finish(
                        tokenizer.decode(req.tokens[: pending.max_tokens]))

    def _serve_group(self, group) -> None:
        try:
            tokenizer = self.generator.tokenizer
            prompts = [tokenizer.encode(p.prompt) for p in group]
            max_tokens = max(p.max_tokens for p in group)
            # sampling params are per-batch on device: serve groups with
            # homogeneous sampler settings together, else fall back
            # per-item
            keys = {p.sampler_key() for p in group}
            if len(keys) == 1 and len(group) > 1:
                p0 = group[0]
                outs = self.generator.generate_batch_device(
                    prompts, max_tokens=max_tokens,
                    temperature=p0.temperature, top_p=p0.top_p,
                    top_k=p0.top_k, seed=p0.seed,
                    repeat_penalty=p0.repeat_penalty,
                    frequency_penalty=p0.frequency_penalty,
                    presence_penalty=p0.presence_penalty,
                )
            else:
                outs = [
                    self.generator.generate_ids_device(
                        prompt, max_tokens=p.max_tokens,
                        temperature=p.temperature, top_p=p.top_p,
                        top_k=p.top_k, seed=p.seed,
                        repeat_penalty=p.repeat_penalty,
                        frequency_penalty=p.frequency_penalty,
                        presence_penalty=p.presence_penalty,
                    )
                    for prompt, p in zip(prompts, group)
                ]
            for pending, out in zip(group, outs):
                pending.finish(tokenizer.decode(out[: pending.max_tokens]))
        except Exception:
            self.errors += 1
            self.error_log.append(traceback.format_exc())
            for pending in group:
                pending.finish("")

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "LocalGenerationServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> str:
        self.start()
        return self.url

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
