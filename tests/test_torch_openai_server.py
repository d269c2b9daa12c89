"""The port's OpenAI-compatible server and ``GanqModel.generate_stream``.

A tiny random llama (2 layers, hidden 64, vocab 256) on the CPU with a
char-level tokenizer defined here (``tests/test_api.py::CharTokenizer``);
``GanqModel.serve(port=0)`` listens on a free localhost port. Each
endpoint's text must be what ``GanqModel.generate`` gives for the same
prompt, with and without the continuous-batching engine behind it.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ganq_tpu_torch import GanqModel
from ganq_tpu_torch.models import synthetic as tsyn
from test_torch_packing import torch_threads_per_worker  # noqa: F401


class CharTokenizer:
    """Minimal char-level tokenizer (no downloads)."""
    eos_token_id = 0
    chat_template = None

    def __call__(self, text):
        return {"input_ids": [min(1 + ord(c) % 250, 255) for c in text]}

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


class PairTokenizer(CharTokenizer):
    """Decodes ids two at a time: an odd count ends in U+FFFD, as a
    multi-byte character cut in half does."""

    def decode(self, ids):
        whole = super().decode(ids[:len(ids) // 2 * 2])
        return whole + ("�" if len(ids) % 2 else "")


@pytest.fixture(scope="module")
def model():
    cfg = tsyn.llama_config(hidden=64, inter=128, layers=2, heads=4,
                            kv_heads=2, vocab=256, max_pos=256)
    m = tsyn.make_model(cfg, kind="dense", seed=4, device="cpu",
                        dtype=torch.float32)
    return GanqModel(cfg, m, tokenizer=CharTokenizer(), device="cpu")


def _post(srv, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
        return (raw if r.headers["Content-Type"] == "text/event-stream"
                else json.loads(raw))


def _sse(raw):
    """The chunks of an SSE body, which must end with the [DONE] event."""
    events = [e[len("data: "):] for e in raw.split("\n\n") if e]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


@pytest.mark.parametrize("use_batching", [False, True])
def test_endpoints_match_generate(model, use_batching):
    """/v1/models lists the model; /v1/completions and /v1/chat/completions
    answer with ``generate``'s text for the prompt (the chat rendered as
    "role: content" lines without a chat template), plain and as an SSE
    stream that ends in [DONE] (with batching the stream is one delta, as
    in ganq_tpu); a request without a prompt is a 400, an unknown path a
    404."""
    srv = model.serve(port=0, use_batching=use_batching, slots=2,
                      max_seq=128)
    try:
        srv.wait_until_ready()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["id"] == srv.model_id
        want = model.generate("hello", max_new_tokens=5)
        out = _post(srv, "/v1/completions", {"prompt": "hello",
                                             "max_tokens": 5})
        assert out["choices"][0]["text"] == want
        msgs = [{"role": "user", "content": "hi there"}]
        want_chat = model.generate("user: hi there\nassistant:",
                                   max_new_tokens=4)
        out = _post(srv, "/v1/chat/completions", {"messages": msgs,
                                                  "max_tokens": 4})
        assert out["choices"][0]["message"] == {"role": "assistant",
                                                "content": want_chat}
        chunks = _sse(_post(srv, "/v1/completions", {
            "prompt": "hello", "max_tokens": 5, "stream": True}))
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        assert "".join(c["choices"][0]["text"] for c in chunks) == want
        chunks = _sse(_post(srv, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 4, "stream": True}))
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks) == want_chat
        if use_batching:
            assert len(chunks) == 2
        for path, body, code in (("/v1/completions", {}, 400),
                                 ("/v1/nothing", {"prompt": "x"}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv, path, body)
            assert e.value.code == code
    finally:
        srv.shutdown()


def test_generate_stream_deltas(model):
    """``generate_stream``'s text deltas joined give ``generate``'s text;
    token ids stream for id input; a delta is held back while the decoded
    text ends in U+FFFD, so none carries half a character."""
    want = model.generate("stream me", max_new_tokens=7)
    deltas = list(model.generate_stream("stream me", max_new_tokens=7))
    assert "".join(deltas) == want and len(deltas) > 1
    ids = np.asarray(CharTokenizer()("stream me")["input_ids"])
    toks = list(model.generate_stream(ids, max_new_tokens=7))
    assert toks == model.generate(ids, max_new_tokens=7)[0].tolist()
    paired = GanqModel(model.cfg, model.model, tokenizer=PairTokenizer(),
                       device="cpu")
    deltas = list(paired.generate_stream("stream me", max_new_tokens=6))
    assert all("�" not in d and len(d) % 2 == 0 for d in deltas)
    assert "".join(deltas) == paired.generate("stream me", max_new_tokens=6)
