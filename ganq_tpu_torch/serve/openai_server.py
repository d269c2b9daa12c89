"""OpenAI-compatible HTTP server on the standard library's
``ThreadingHTTPServer``.

The port of ``ganq_tpu/serve/openai_server.py``: ``POST
/v1/chat/completions`` (the tokenizer's chat template where it has one),
``POST /v1/completions``, ``GET /v1/models``, server-sent-event streaming
ending in ``[DONE]``, a readiness probe and a clean shutdown. Without
``use_batching`` one request at a time runs ``GanqModel.generate`` (or
``generate_stream`` for a stream); with it, concurrent requests share the
decode steps of a :class:`~ganq_tpu_torch.serve.batching.ThreadedBatcher`
over ``slots`` cache slots, and a stream arrives as one delta.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..utils.logger import get_logger

log = get_logger(__name__)


class OpenAIServer:
    def __init__(self, model, host: str = "127.0.0.1", port: int = 8000,
                 model_id: str = "ganq-tpu-torch-model",
                 max_new_tokens: int = 256,
                 use_batching: bool = False, slots: int = 4,
                 max_seq: int = 1024):
        self.model = model
        self.host = host
        self.port = port
        self.model_id = model_id
        self.max_new_tokens = max_new_tokens
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # one generate at a time on the card
        self._batcher = None
        if use_batching:
            from .batching import ThreadedBatcher
            eos = -1
            if (model.tokenizer is not None
                    and model.tokenizer.eos_token_id is not None):
                eos = int(model.tokenizer.eos_token_id)
            self._batcher = ThreadedBatcher(
                model.cfg, model.model, backend=model.backend,
                slots=slots, max_seq=min(max_seq,
                                         model.cfg.max_position_embeddings),
                eos_id=eos, device=model.device)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "OpenAIServer":
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info(f"OpenAI server on http://{self.host}:{self.port}")
        return self

    def shutdown(self) -> None:
        if self._batcher is not None:
            self._batcher.shutdown()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def wait_until_ready(self, timeout: float = 30.0) -> None:
        deadline = time.time() + timeout
        url = f"http://{self.host}:{self.port}/v1/models"
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(url, timeout=2):
                    return
            except Exception:
                time.sleep(0.1)
        raise TimeoutError("server did not become ready")

    # -------------------------------------------------------------- handlers
    def _render_prompt(self, messages) -> Any:
        tok = self.model.tokenizer
        if tok is not None and getattr(tok, "chat_template", None):
            return tok.apply_chat_template(messages, tokenize=False,
                                           add_generation_prompt=True)
        return "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                         for m in messages) + "\nassistant:"

    def _stream_deltas(self, prompt: str, body: Dict[str, Any]):
        """Yield text deltas for an SSE response. The batching engine has no
        incremental path, so with use_batching the full result arrives as
        one delta (still a valid SSE stream)."""
        max_new = int(body.get("max_tokens") or self.max_new_tokens)
        temperature = float(body.get("temperature", 0.0) or 0.0)
        if self._batcher is not None:
            yield self._generate(prompt, body)
            return
        with self._lock:
            yield from self.model.generate_stream(
                prompt, max_new_tokens=max_new, temperature=temperature,
                top_k=int(body.get("top_k", 0) or 0))

    def _generate(self, prompt: str, body: Dict[str, Any]) -> str:
        max_new = int(body.get("max_tokens") or self.max_new_tokens)
        temperature = float(body.get("temperature", 0.0) or 0.0)
        if self._batcher is not None:
            tok = self.model.tokenizer
            if tok is None:
                raise ValueError("string input requires a tokenizer")
            ids = tok(prompt)["input_ids"]
            out = self._batcher.generate_ids(ids, max_new_tokens=max_new,
                                             temperature=temperature)
            eos = tok.eos_token_id
            return tok.decode([t for t in out if t != eos])
        with self._lock:
            return self.model.generate(prompt, max_new_tokens=max_new,
                                       temperature=temperature,
                                       top_k=int(body.get("top_k", 0) or 0))

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_sse(self, deltas, chunk_of):
                """OpenAI-style SSE: one chunk per delta, a finish chunk,
                then the [DONE] sentinel."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def emit(obj):
                    self.wfile.write(b"data: " + json.dumps(obj).encode()
                                     + b"\n\n")
                    self.wfile.flush()

                for delta in deltas:
                    emit(chunk_of(delta, None))
                emit(chunk_of(None, "stop"))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

            def do_GET(self):
                if self.path == "/v1/models":
                    self._send(200, {"object": "list", "data": [
                        {"id": server.model_id, "object": "model",
                         "owned_by": "ganq-tpu-torch"}]})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                except Exception:
                    return self._send(400, {"error": "invalid JSON body"})
                try:
                    if self.path == "/v1/chat/completions":
                        msgs = body.get("messages")
                        if not isinstance(msgs, list) or not msgs:
                            return self._send(400, {"error": "messages required"})
                        prompt = server._render_prompt(msgs)
                        if body.get("stream"):
                            created = int(time.time())
                            state = {"first": True}

                            def chat_chunk(delta, finish):
                                d: Dict[str, Any] = {}
                                if finish is None:
                                    d["content"] = delta
                                    if state["first"]:  # role rides chunk #1
                                        d["role"] = "assistant"
                                        state["first"] = False
                                return {
                                    "id": "chatcmpl-ganq",
                                    "object": "chat.completion.chunk",
                                    "created": created,
                                    "model": server.model_id,
                                    "choices": [{"index": 0, "delta": d,
                                                 "finish_reason": finish}]}
                            return self._send_sse(
                                server._stream_deltas(prompt, body), chat_chunk)
                        text = server._generate(prompt, body)
                        self._send(200, {
                            "id": "chatcmpl-ganq", "object": "chat.completion",
                            "created": int(time.time()), "model": server.model_id,
                            "choices": [{"index": 0,
                                         "message": {"role": "assistant",
                                                     "content": text},
                                         "finish_reason": "stop"}]})
                    elif self.path == "/v1/completions":
                        prompt = body.get("prompt")
                        if not isinstance(prompt, str):
                            return self._send(400, {"error": "prompt required"})
                        if body.get("stream"):
                            created = int(time.time())

                            def text_chunk(delta, finish):
                                return {
                                    "id": "cmpl-ganq",
                                    "object": "text_completion",
                                    "created": created,
                                    "model": server.model_id,
                                    "choices": [{"index": 0,
                                                 "text": delta or "",
                                                 "finish_reason": finish}]}
                            return self._send_sse(
                                server._stream_deltas(prompt, body), text_chunk)
                        text = server._generate(prompt, body)
                        self._send(200, {
                            "id": "cmpl-ganq", "object": "text_completion",
                            "created": int(time.time()), "model": server.model_id,
                            "choices": [{"index": 0, "text": text,
                                         "finish_reason": "stop"}]})
                    else:
                        self._send(404, {"error": "not found"})
                except Exception as e:  # model errors become 500s
                    log.exception("request failed")
                    self._send(500, {"error": str(e)})

        return Handler


__all__ = ["OpenAIServer"]
