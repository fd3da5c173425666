"""HTTP client for a llama.cpp-style generation server.

A copy of ``persian_rag_tpu.gen.client`` on ``urllib`` (the standard
library only): health probing via /health then /v1/models, generation with
the /completion -> /v1/chat/completions -> /chat endpoint fallback chain,
the same Persian stop lists, the same aggressive prediction cleaning, the
same Persian RAG prompt template and answer post-processing. A server that
does not answer gives ``None``, never an exception.

The server is any llama.cpp-contract process: an external llama.cpp, or
``persian_rag_tpu_torch.gen.local_server.LocalGenerationServer``.
"""
from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

DEFAULT_STOP = ["</s>", "<|eot_id|>", "\n\nسوال:", "\n\nپرسش:", "Human:", "user:"]

RAG_STOP = [
    "</s>", "<|eot_id|>", "\n\nسوال:", "\n\nپرسش:",
    "\n\nQuestion:", "Human:", "user:", "\n\nمتن",
    "اطلاعات مرجع:", "بر اساس",
]

_PROMPT_PREFIXES = [
    r"بر اساس اطلاعات ارائه شده[،:]?\s*",
    r"با توجه به متن[،:]?\s*",
    r"طبق اطلاعات[،:]?\s*",
    r"پاسخ[:\s]*",
]

_RAG_ANSWER_PREFIXES = ["کوتاه و مستقیم:", "مستقیم:", "کوتاه:", "دقیق:"]


class LlamaClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8080", timeout: int = 120):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.connected = self._test_connection()

    # -- transport ---------------------------------------------------------------

    def _request(self, path: str, payload: Optional[Dict] = None,
                 timeout: float = 5) -> Tuple[int, bytes]:
        """GET (no payload) or POST JSON; returns (status, body). An HTTP
        error status is returned, not raised; a server that cannot be
        reached raises."""
        data, headers = None, {}
        if payload is not None:
            data = json.dumps(payload).encode()
            headers = {"Content-Type": "application/json"}
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _post_json(self, path: str, payload: Dict) -> Optional[Dict]:
        status, body = self._request(path, payload, timeout=self.timeout)
        return json.loads(body) if status == 200 else None

    def _test_connection(self) -> bool:
        try:
            return self._request("/health")[0] == 200
        except Exception:
            try:
                return self._request("/v1/models")[0] in (200, 404)
            except Exception:
                return False

    # -- response cleaning ----------------------------------------------------

    def clean_prediction(self, text: str) -> str:
        if not text:
            return ""
        text = re.sub(r"<\|[^|]*\|>", "", text)
        text = re.sub(r"user[a-zA-Z]*", "", text)
        text = re.sub(r"assistant[a-zA-Z]*", "", text)
        text = re.sub(r"<[^>]*>", "", text)
        text = re.sub(r"system[:\s]*", "", text, flags=re.IGNORECASE)
        text = re.sub(r"human[:\s]*", "", text, flags=re.IGNORECASE)
        text = re.sub(r"ai[:\s]*", "", text, flags=re.IGNORECASE)
        for pattern in _PROMPT_PREFIXES:
            text = re.sub(pattern, "", text)
        text = re.sub(r"\s+", " ", text).strip()
        text = re.sub(r"\s+\.\.\.$", "", text)
        sentences = [s.strip() for s in text.split(".") if s.strip()]
        if sentences:
            best = max(
                sentences, key=lambda s: len(s) if len(s.split()) > 2 else 0
            )
            if len(best) > 10:
                text = best
            else:
                text = sentences[0]
        if len(text) > 100:
            words = text.split()
            if len(words) > 15:
                text = " ".join(words[:15])
        return text.strip()

    # -- endpoints -------------------------------------------------------------

    def _try_completion(self, payload: Dict) -> Optional[str]:
        try:
            data = self._post_json("/completion", payload)
            if data is not None:
                if "content" in data:
                    return data["content"].strip()
                if data.get("choices"):
                    return data["choices"][0]["text"].strip()
        except Exception:
            pass
        return None

    def _try_chat(self, prompt: str, payload: Dict) -> Optional[str]:
        chat_payload = {
            "messages": [{"role": "user", "content": prompt}],
            "max_tokens": payload.get("max_tokens", 512),
            "temperature": payload.get("temperature", 0.1),
            "top_p": payload.get("top_p", 0.9),
            "stream": False,
        }
        try:
            data = self._post_json("/v1/chat/completions", chat_payload)
            if data is not None and data.get("choices"):
                return data["choices"][0]["message"]["content"].strip()
        except Exception:
            pass
        try:
            data = self._post_json("/chat", chat_payload)
            if data is not None:
                if "content" in data:
                    return data["content"].strip()
                if "response" in data:
                    return data["response"].strip()
        except Exception:
            pass
        return None

    def generate(
        self,
        prompt: str,
        max_tokens: int = 512,
        temperature: float = 0.1,
        top_p: float = 0.9,
        stop: Optional[List[str]] = None,
    ) -> Optional[str]:
        payload = {
            "prompt": prompt,
            "max_tokens": max_tokens,
            "temperature": temperature,
            "top_p": top_p,
            "stream": False,
            "stop": stop or list(DEFAULT_STOP),
        }
        response = self._try_completion(payload)
        if response:
            return self.clean_prediction(response)
        response = self._try_chat(prompt, payload)
        if response:
            return self.clean_prediction(response)
        return None

    # -- RAG prompt ---------------------------------------------------------------

    def create_rag_prompt(
        self, question: str, contexts: List[str], max_context_length: int = 2000
    ) -> str:
        combined = ""
        length = 0
        for i, context in enumerate(contexts):
            block = f"متن {i + 1}: {context}\n\n"
            if length + len(block) > max_context_length:
                break
            combined += block
            length += len(block)
        return (
            "بر اساس اطلاعات زیر، به سوال پاسخ کوتاه و دقیق دهید.\n\n"
            "اطلاعات مرجع:\n"
            f"{combined.strip()}\n\n"
            f"سوال: {question}\n\n"
            "پاسخ کوتاه و مستقیم:"
        )

    def answer_question(
        self,
        question: str,
        contexts: List[str],
        max_tokens: int = 128,
        temperature: float = 0.05,
    ) -> Optional[str]:
        prompt = self.create_rag_prompt(question, contexts)
        response = self.generate(
            prompt=prompt,
            max_tokens=max_tokens,
            temperature=temperature,
            top_p=0.85,
            stop=list(RAG_STOP),
        )
        if not response:
            return None
        response = response.strip()
        if "پاسخ" in response and ":" in response:
            parts = response.split(":")
            if len(parts) > 1:
                response = ":".join(parts[1:]).strip()
        for prefix in _RAG_ANSWER_PREFIXES:
            if response.startswith(prefix):
                response = response[len(prefix):].strip()
        return response

    def batch_answer(
        self,
        questions_contexts: List[Dict],
        max_tokens: int = 128,
        temperature: float = 0.05,
        delay_between_requests: float = 0.0,
    ) -> List[Optional[str]]:
        answers = []
        for item in questions_contexts:
            answers.append(
                self.answer_question(
                    item["question"],
                    item["contexts"],
                    max_tokens=max_tokens,
                    temperature=temperature,
                )
            )
            if delay_between_requests > 0:
                time.sleep(delay_between_requests)
        return answers

    def get_server_info(self) -> Dict:
        info: Dict = {"status": "unknown", "base_url": self.base_url, "endpoints": []}
        for endpoint in (
            "/health",
            "/v1/models",
            "/completion",
            "/chat",
            "/v1/chat/completions",
        ):
            try:
                if self._request(endpoint)[0] in (200, 405):
                    info["endpoints"].append(endpoint)
            except Exception:
                pass
        info["status"] = "connected" if info["endpoints"] else "disconnected"
        return info

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass
