"""The port's OpenAI-compatible facade (``serve/api.py`` /v1/completions,
/v1/chat/completions, /v1/models, /tokenize, /detokenize) on the CPU: every
case of ``tests/test_openai_api.py`` over the port's ``ContinuousEngine``
(f32, random weights from a seed) at that file's width: the wire
shapes, token parity with /generate, batched prompts, n > 1, stop
sequences, logprobs, SSE chunks ending in [DONE], the error envelope."""

import json
import urllib.request

import pytest

from autosmoothquant_tpu_torch.serve.api import serve

from test_torch_util import (ToyTok, http_post, port_continuous, port_tiny, start_server,
                             stop_server)


@pytest.fixture(scope="module")
def tiny():
    return port_tiny()


@pytest.fixture(scope="module")
def server(tiny):
    api, httpd, port = start_server(serve, port_continuous(*tiny), model_id="tiny-llama-int8")
    yield api, port
    stop_server(api, httpd)


PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def test_models_endpoint(server):
    _, port = server
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
        out = json.loads(r.read())
    assert out["object"] == "list"
    assert out["data"][0]["id"] == "tiny-llama-int8"


def test_completion_envelope_and_parity_with_generate(server):
    """Greedy /v1/completions returns the standard envelope and the SAME
    tokens as the native /generate endpoint."""
    _, port = server
    status, want = http_post(port, "/generate",
                             {"prompt": PROMPT, "max_new_tokens": 8})
    assert status == 200
    status, out = http_post(port, "/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 8,
                             "temperature": 0.0})
    assert status == 200
    assert out["object"] == "text_completion"
    assert out["id"].startswith("cmpl-")
    assert out["model"] == "tiny-llama-int8"
    (c,) = out["choices"]
    assert c["index"] == 0 and c["finish_reason"] == "length"
    assert c["tokens"] == want["tokens"]
    assert out["usage"] == {"prompt_tokens": len(PROMPT),
                            "completion_tokens": 8,
                            "total_tokens": len(PROMPT) + 8}


def test_batched_prompts_and_n_samples(server):
    """A batch of 2 prompts with n=2: four choices, prompt-major index
    order; greedy duplicates within a prompt are identical."""
    _, port = server
    p2 = [7, 7, 7, 7]
    status, out = http_post(port, "/v1/completions",
                            {"prompt": [PROMPT, p2], "n": 2, "max_tokens": 6,
                             "temperature": 0.0})
    assert status == 200
    assert [c["index"] for c in out["choices"]] == [0, 1, 2, 3]
    toks = [c["tokens"] for c in out["choices"]]
    assert toks[0] == toks[1] and toks[2] == toks[3]  # greedy n=2 agrees
    assert toks[0] != toks[2]                          # different prompts
    # OpenAI counts prompt tokens once per request, not per sampled choice
    assert out["usage"]["prompt_tokens"] == len(PROMPT) + len(p2)
    assert out["usage"]["completion_tokens"] == 24


def test_sampling_defaults_are_openai(server):
    """No temperature given -> OpenAI's default 1.0 (sampling), so two
    single-shot calls are allowed to disagree while a temperature-0 call
    is deterministic. (With a fixed engine seed the sampled path is still
    exercised; we only assert the greedy pin.)"""
    _, port = server
    status, a = http_post(port, "/v1/completions",
                          {"prompt": PROMPT, "max_tokens": 6,
                           "temperature": 0.0})
    status, b = http_post(port, "/v1/completions",
                          {"prompt": PROMPT, "max_tokens": 6,
                           "temperature": 0.0})
    assert a["choices"][0]["tokens"] == b["choices"][0]["tokens"]
    status, c = http_post(port, "/v1/completions",
                          {"prompt": PROMPT, "max_tokens": 6})
    assert status == 200 and len(c["choices"][0]["tokens"]) == 6


def test_stop_token_ids_and_finish_reason(server):
    """Token-id stop lists work without a tokenizer; hitting one yields
    finish_reason='stop' and truncated output."""
    _, port = server
    status, free = http_post(port, "/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 8,
                              "temperature": 0.0})
    toks = free["choices"][0]["tokens"]
    stop_at = toks[3]  # stop on the 4th greedy token
    status, out = http_post(port, "/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 8,
                             "temperature": 0.0, "stop": [[stop_at]]})
    assert status == 200
    c = out["choices"][0]
    assert c["finish_reason"] == "stop"
    assert len(c["tokens"]) < 8
    assert stop_at not in c["tokens"]


def test_logprobs(server):
    _, port = server
    status, out = http_post(port, "/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 5,
                             "temperature": 0.0, "logprobs": 1})
    assert status == 200
    lp = out["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == 5
    assert all(x <= 0.0 for x in lp["token_logprobs"])
    assert len(lp["tokens"]) == 5


def test_streaming_chunks_prefix_of_done(server):
    """SSE chunks: concatenated streamed tokens equal the non-streamed
    result; the stream ends with `data: [DONE]` and the last content chunk
    carries finish_reason."""
    _, port = server
    status, want = http_post(port, "/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 8,
                              "temperature": 0.0})
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": PROMPT, "max_tokens": 8,
                         "temperature": 0.0, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "text_completion" for c in chunks)
    streamed = [t for c in chunks for t in c["choices"][0]["tokens"]]
    assert streamed == want["choices"][0]["tokens"]
    finishes = [c["choices"][0]["finish_reason"] for c in chunks]
    assert finishes[-1] == "length"
    assert all(f is None for f in finishes[:-1])


def test_bare_int_stop(server):
    """A single bare stop token id (OpenAI allows a scalar stop)."""
    _, port = server
    status, free = http_post(port, "/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 8,
                              "temperature": 0.0})
    stop_at = free["choices"][0]["tokens"][2]
    status, out = http_post(port, "/v1/completions",
                            {"prompt": PROMPT, "max_tokens": 8,
                             "temperature": 0.0, "stop": stop_at})
    assert status == 200
    assert out["choices"][0]["finish_reason"] == "stop"
    assert stop_at not in out["choices"][0]["tokens"]


def test_streamed_logprobs_stay_aligned(server):
    """stream+logprobs+stop: every chunk's logprobs tokens/token_logprobs
    have EQUAL length (the finish chunk must slice lps to its tail, not
    attach the whole request's list)."""
    _, port = server
    status, free = http_post(port, "/v1/completions",
                             {"prompt": PROMPT, "max_tokens": 8,
                              "temperature": 0.0})
    stop_at = free["choices"][0]["tokens"][5]  # stops late: chunks stream
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": PROMPT, "max_tokens": 8,
                         "temperature": 0.0, "logprobs": 1,
                         "stop": [[stop_at]], "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                chunks.append(json.loads(line[len("data: "):]))
    saw_lp = False
    for c in chunks:
        ch = c["choices"][0]
        if ch["logprobs"] is not None:
            saw_lp = True
            assert (len(ch["logprobs"]["tokens"])
                    == len(ch["logprobs"]["token_logprobs"]))
            assert len(ch["logprobs"]["tokens"]) == len(ch["tokens"])
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert saw_lp


def test_stream_options_include_usage(server):
    """stream_options.include_usage: a final usage chunk (empty choices)
    precedes [DONE]."""
    _, port = server
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": PROMPT, "max_tokens": 5,
                         "temperature": 0.0, "stream": True,
                         "stream_options": {"include_usage": True}}
                        ).encode(),
        headers={"Content-Type": "application/json"})
    datas = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                datas.append(line[len("data: "):])
    assert datas[-1] == "[DONE]"
    usage_chunk = json.loads(datas[-2])
    assert usage_chunk["choices"] == []
    assert usage_chunk["usage"] == {"prompt_tokens": len(PROMPT),
                                    "completion_tokens": 5,
                                    "total_tokens": len(PROMPT) + 5}


def test_error_envelope(server):
    _, port = server
    status, out = http_post(port, "/v1/completions", {"prompt": []})
    assert status == 400
    assert out["error"]["type"] == "invalid_request_error"
    status, out = http_post(port, "/v1/completions",
                            {"prompt": "text", "max_tokens": 4})
    assert status == 400  # no tokenizer configured on this server
    status, out = http_post(port, "/v1/completions",
                            {"prompt": PROMPT, "stream": True, "n": 2})
    assert status == 400


@pytest.fixture(scope="module")
def tok_server(tiny):
    api, httpd, port = start_server(serve, port_continuous(*tiny, max_batch=2),
                                    tokenizer=ToyTok())
    yield api, port
    stop_server(api, httpd)


def test_tokenized_text_path(tok_server):
    """With a toy tokenizer, text prompts/stops and echo round-trip."""
    _, port = tok_server
    status, out = http_post(port, "/v1/completions",
                            {"prompt": "hello", "max_tokens": 4,
                             "temperature": 0.0, "echo": True})
    assert status == 200
    c = out["choices"][0]
    assert c["text"].startswith("hello")
    assert len(c["tokens"]) == 4


def test_chat_completion(tok_server):
    """/v1/chat/completions: generic role-header template (ToyTok has no
    apply_chat_template), chat.completion envelope, assistant message."""
    _, port = tok_server
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    status, out = http_post(port, "/v1/chat/completions",
                            {"messages": msgs, "max_tokens": 5,
                             "temperature": 0.0})
    assert status == 200
    assert out["object"] == "chat.completion"
    assert out["id"].startswith("chatcmpl-")
    (c,) = out["choices"]
    assert c["message"]["role"] == "assistant"
    assert isinstance(c["message"]["content"], str)
    assert len(c["tokens"]) == 5 and c["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 5
    # deterministic: same messages, same greedy content
    status, out2 = http_post(port, "/v1/chat/completions",
                             {"messages": msgs, "max_tokens": 5,
                              "temperature": 0.0})
    assert out2["choices"][0]["tokens"] == c["tokens"]


def test_chat_uses_tokenizer_template_when_present(tok_server):
    """A tokenizer exposing apply_chat_template takes precedence over the
    generic role-header fallback."""
    api, port = tok_server
    calls = []

    class TemplTok(ToyTok):
        def apply_chat_template(self, messages, add_generation_prompt=True,
                                tokenize=True):
            calls.append(list(messages))
            return list(self("T:" + messages[-1]["content"]))

    old = api.tokenizer
    api.tokenizer = TemplTok()
    try:
        status, out = http_post(port, "/v1/chat/completions",
                                {"messages": [{"role": "user",
                                               "content": "yo"}],
                                 "max_tokens": 3, "temperature": 0.0})
        assert status == 200 and calls  # template path was used
    finally:
        api.tokenizer = old


def test_chat_streaming(tok_server):
    _, port = tok_server
    msgs = [{"role": "user", "content": "stream please"}]
    status, want = http_post(port, "/v1/chat/completions",
                             {"messages": msgs, "max_tokens": 6,
                              "temperature": 0.0})
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": msgs, "max_tokens": 6,
                         "temperature": 0.0, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == want["choices"][0]["message"]["content"]
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")


def test_tokenize_detokenize_endpoints(tok_server):
    api, port = tok_server
    status, out = http_post(port, "/tokenize", {"text": "hello"})
    assert status == 200 and out["count"] == 5
    status, back = http_post(port, "/detokenize", {"tokens": out["tokens"]})
    assert status == 200 and back["text"] == "hello"
    status, _ = http_post(port, "/tokenize", {"text": 7})
    assert status == 400
    status, _ = http_post(port, "/detokenize", {"tokens": "x"})
    assert status == 400


def test_tokenize_requires_tokenizer(server):
    _, port = server
    status, out = http_post(port, "/tokenize", {"text": "hi"})
    assert status == 400 and "tokenizer" in out["error"]


def test_chat_errors(server):
    """Chat needs a tokenizer (the plain module server has none) and
    validates the messages shape."""
    _, port = server
    status, out = http_post(port, "/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "x"}]})
    assert status == 400
    assert out["error"]["type"] == "invalid_request_error"
    status, out = http_post(port, "/v1/chat/completions", {"messages": []})
    assert status == 400
