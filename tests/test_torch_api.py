"""The port's HTTP facade (``autosmoothquant_tpu_torch/serve/api.py``) on the
CPU: every case of ``tests/test_api.py`` and the HTTP cases of
``tests/test_serving_hardening.py``, over the port's ``ContinuousEngine``
(f32 compute and KV, random weights from a seed) at those files' widths;
plus the port's own rules: a CUDA error loses the device for good (every
later request fails fast with its text), and the engine methods the
scheduler thread calls run whatever the calling thread's grad mode."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.serve.api import ServingAPI, cuda_context_lost, serve
from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

from test_torch_util import (http_get, http_post, http_stream, port_continuous, port_tiny,
                             start_server, stop_server)

# tests/test_serving_hardening.py's width
HARDENING = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)


@pytest.fixture(scope="module")
def tiny():
    return port_tiny()


def _engine(tiny, **kw):
    return port_continuous(*tiny, **kw)


def _static(tiny):
    TL, cfg, params = tiny
    return Engine(TL, params, cfg, max_batch=1, max_seq=64, kv_dtype=torch.float32,
                  compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def server(tiny):
    api, httpd, port = start_server(serve, _engine(tiny))
    yield tiny, api, port
    stop_server(api, httpd)


def test_generate_matches_engine(server):
    tiny, api, port = server
    prompt = np.random.default_rng(0).integers(1, 128, size=7).tolist()
    want = _static(tiny).generate([prompt], GenerationConfig(max_new_tokens=8))[0]
    status, out = http_post(port, "/generate", {"prompt": prompt, "max_new_tokens": 8})
    assert status == 200
    assert out["tokens"] == want


def test_paged_engine_serves_a_request_and_a_prefix(tiny):
    """The facade over the port's PagedEngine (explicit prefixes): a request
    and one on a prefix registered over HTTP, each the static engine's
    tokens; /stats reports the pages, and every page is back after."""
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    TL, cfg, params = tiny
    eng = PagedEngine(TL, params, cfg, max_batch=4, max_seq=64, block_size=16,
                      kv_dtype=torch.float32, compute_dtype=torch.float32,
                      auto_prefix=False, device="cpu")
    api, httpd, port = start_server(serve, eng)
    try:
        rng = np.random.default_rng(11)
        prefix = rng.integers(1, 128, size=20).tolist()
        prompt = prefix + rng.integers(1, 128, size=5).tolist()
        want = _static(tiny).generate([prompt], GenerationConfig(max_new_tokens=6))[0]
        status, out = http_post(port, "/generate", {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200 and out["tokens"] == want
        status, resp = http_post(port, "/prefix", {"id": "sys", "tokens": prefix})
        assert status == 200 and resp["prefix_tokens"] == 20
        status, out = http_post(port, "/generate", {"prompt": prompt, "max_new_tokens": 6,
                                                     "prefix": "sys"})
        assert status == 200 and out["tokens"] == want
        status, stats = http_get(port, "/stats")
        assert status == 200 and stats["num_pages"] == eng.num_pages
        assert stats["free_pages"] == eng.num_pages - 1 - 2  # the prefix's 2 pages
    finally:
        stop_server(api, httpd)


def test_concurrent_requests(server):
    tiny, api, port = server
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, size=5 + i).tolist() for i in range(6)]
    results = [None] * len(prompts)

    def hit(i):
        status, out = http_post(port, "/generate", {"prompt": prompts[i], "max_new_tokens": 6})
        results[i] = (status, out["tokens"])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    ref = _static(tiny)
    for i, p in enumerate(prompts):
        want = ref.generate([p], GenerationConfig(max_new_tokens=6))[0]
        assert results[i] == (200, want), i


def test_a_burst_of_clients_is_served(server):
    """64 clients connecting at once, each streaming: every one is answered
    in full (with socketserver's default listen backlog of 5, the reference
    server's, some of these connections are reset)."""
    _, _, port = server
    done, errors = {}, []

    def one(i):
        try:
            events = http_stream(port, "/generate", {"prompt": [1 + i % 100, 2, 3],
                                                     "max_new_tokens": 3, "stream": True})
            done[i] = json.loads(events[-1][1])["tokens"]
        except OSError as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(done) == 64
    assert all(len(t) == 3 for t in done.values())


def test_sampling_params_accepted(server):
    _, _, port = server
    status, out = http_post(port, "/generate", {"prompt": [3, 4, 5], "max_new_tokens": 5,
                                                "temperature": 0.9, "top_k": 10, "top_p": 0.9})
    assert status == 200
    assert len(out["tokens"]) == 5


def test_engine_error_fails_fast_and_keeps_serving(tiny):
    """A host-side exception from a tick fails the requests in flight at once,
    leaks no bookkeeping, and the server keeps serving."""
    eng = _engine(tiny)
    api = ServingAPI(eng).start()
    try:
        boom = {"n": 0}
        orig = eng.step

        def flaky():
            if boom["n"] == 0:
                boom["n"] += 1
                raise RuntimeError("injected device error")
            return orig()

        eng.step = flaky
        with pytest.raises(RuntimeError, match="injected"):
            api.submit([1, 2, 3], max_new_tokens=4, timeout=30)
        out = api.submit([1, 2, 3], max_new_tokens=4, timeout=60)
        assert len(out) == 4
        assert not api._events and not api._results and not api._errors
        assert api.fatal is None
    finally:
        api.stop()


def test_timeout_cleans_up_bookkeeping(tiny):
    eng = _engine(tiny)
    api = ServingAPI(eng).start()
    try:
        orig = eng.step
        eng.step = lambda: (time.sleep(0.4), orig())[1]
        with pytest.raises(TimeoutError):
            api.submit([1, 2, 3], max_new_tokens=64, timeout=0.05)
        eng.step = orig
        deadline = time.time() + 60
        while time.time() < deadline and (eng.waiting
                                          or any(r is not None for r in eng.slot_req)):
            time.sleep(0.05)
        assert not api._results and not api._events
    finally:
        api.stop()


def test_health_and_errors(server):
    _, _, port = server
    status, h = http_get(port, "/health")
    assert status == 200 and h["ok"] is True
    status, out = http_post(port, "/generate", {"prompt": []})
    assert status == 400 and "error" in out
    status, out = http_post(port, "/generate", {"prompt": "text without tokenizer"})
    assert status == 400 and "tokenizer" in out["error"]


def test_streaming_sse(server):
    """stream=true: incremental events whose tokens are a prefix of the
    non-streamed result, ending with a done event that equals it."""
    _, _, port = server
    prompt = np.random.default_rng(7).integers(1, 128, size=6).tolist()
    _, plain = http_post(port, "/generate", {"prompt": prompt, "max_new_tokens": 10})
    events = [(ev, json.loads(d)) for ev, d in http_stream(
        port, "/generate", {"prompt": prompt, "max_new_tokens": 10, "stream": True})]
    assert events[-1][0] == "done"
    streamed = [t for ev, d in events if ev == "data" for t in d["tokens"]]
    final = events[-1][1]["tokens"]
    assert final == plain["tokens"]
    assert streamed == final[:len(streamed)]


def test_timeout_cancels_engine_work(tiny):
    """A timed-out request is cancelled in the engine (its slot freed), not
    left decoding to its budget."""
    eng = _engine(tiny)
    api = ServingAPI(eng).start()
    try:
        orig = eng.step
        eng.step = lambda: (time.sleep(0.2), orig())[1]
        with pytest.raises(TimeoutError):
            api.submit([1, 2, 3], max_new_tokens=10_000, timeout=0.05)
        eng.step = orig
        deadline = time.time() + 30
        while time.time() < deadline and (
                eng.waiting or eng._admitting or any(r is not None for r in eng.slot_req)):
            time.sleep(0.05)
        assert all(r is None for r in eng.slot_req)
        assert len(api.submit([4, 5], max_new_tokens=3, timeout=60)) == 3
    finally:
        api.stop()


def test_engine_cancel_targets_one_request(tiny):
    eng = _engine(tiny)
    r0 = eng.submit(0, [1, 2, 3], max_new_tokens=40)
    eng.submit(1, [4, 5, 6], max_new_tokens=6)
    assert eng.cancel(0)
    assert not eng.cancel(42)
    out = eng.run()
    assert len(out[1]) == 6
    assert len(r0.output) == 0
    r2 = eng.submit(2, [7, 8, 9], max_new_tokens=1000)
    eng.step()
    assert any(r is r2 for r in eng.slot_req)
    assert eng.cancel(2)
    assert all(r is not r2 for r in eng.slot_req)
    assert len(r2.output) < 1000


def test_prefix_endpoint_roundtrip(server):
    """POST /prefix, then /generate with prefix=<id> gives the tokens of a
    full prefill of the same prompt; after a drop the stale id falls back to
    a full prefill."""
    _, _, port = server
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(1, 128, size=12).tolist()
    user = rng.integers(1, 128, size=5).tolist()
    code, resp = http_post(port, "/prefix", {"id": "sys", "tokens": sys_prompt})
    assert code == 200 and resp["ok"] and resp["prefix_tokens"] == 12
    body = {"prompt": sys_prompt + user, "max_new_tokens": 8}
    code, with_prefix = http_post(port, "/generate", dict(body, prefix="sys"))
    assert code == 200
    code, without = http_post(port, "/generate", body)
    assert code == 200
    assert with_prefix["tokens"] == without["tokens"]
    code, resp = http_post(port, "/prefix", {"id": "sys", "drop": True})
    assert code == 200 and resp["dropped"]
    code, after = http_post(port, "/generate", dict(body, prefix="sys"))
    assert code == 200 and after["tokens"] == without["tokens"]


def test_prefix_endpoint_errors(server):
    _, _, port = server
    code, resp = http_post(port, "/prefix", {"tokens": [1, 2]})
    assert code == 400 and "id" in resp["error"]
    code, resp = http_post(port, "/prefix", {"id": "x", "tokens": []})
    assert code == 400
    code, resp = http_post(port, "/prefix", {"id": "x", "text": "hi"})
    assert code == 400 and "tokenizer" in resp["error"]
    code, resp = http_post(port, "/prefix", {"id": "big", "tokens": list(range(1, 100))})
    assert code == 400 and "error" in resp
    code, resp = http_post(port, "/health", {})
    assert code in (404, 200)


def test_prefix_cap_evicts_lru(tiny):
    """At max_prefixes a registration evicts the least recently used entry
    (never a 429 while one can go); a re-registration is an LRU touch."""
    eng = _engine(tiny, max_prefixes=2)
    api, httpd, port = start_server(serve, eng)
    try:
        for pid in ("a", "b"):
            code, _ = http_post(port, "/prefix", {"id": pid, "tokens": [1, 2, 3]})
            assert code == 200
        code, _ = http_post(port, "/prefix", {"id": "a", "tokens": [4, 5]})
        assert code == 200
        code, _ = http_post(port, "/prefix", {"id": "c", "tokens": [1, 2, 3]})
        assert code == 200
        assert set(eng._prefixes) == {"a", "c"}
        code, _ = http_post(port, "/prefix", {"id": "a", "drop": True})
        assert code == 200
        assert set(eng._prefixes) == {"c"}
    finally:
        stop_server(api, httpd)


def test_prefix_cache_full_answers_429(tiny):
    """With every slot of the prefix cache pinned (max_prefixes 0: none to
    evict), the engine's PrefixCacheFull maps to HTTP 429."""
    eng = _engine(tiny, max_prefixes=0)
    api, httpd, port = start_server(serve, eng)
    try:
        code, resp = http_post(port, "/prefix", {"id": "a", "tokens": [1, 2, 3]})
        assert code == 429 and "full" in resp["error"]
    finally:
        stop_server(api, httpd)


def test_stats_endpoint(tiny):
    eng = _engine(tiny, max_batch=2)
    api, httpd, port = start_server(serve, eng)
    try:
        code, _ = http_post(port, "/generate", {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 6})
        assert code == 200
        code, stats = http_get(port, "/stats")
        assert code == 200 and stats["ok"]
        assert stats["decode_tokens"] >= 6
        assert stats["prefill_tokens"] >= 5
        assert stats["max_batch"] == 2
        assert stats["active"] == 0 and stats["waiting"] == 0
        assert "decode_tok_per_s" in stats and "prefixes" in stats
    finally:
        stop_server(api, httpd)


def test_prefix_timeout_cancels_queued_entry(tiny):
    """A timed-out register_prefix never takes effect later."""
    eng = _engine(tiny)
    api = ServingAPI(eng)
    with pytest.raises(TimeoutError):
        api.register_prefix("late", [1, 2, 3], timeout=0.01)
    api.start()
    try:
        api.register_prefix("ok", [4, 5], timeout=60)
        assert "ok" in eng._prefixes
        assert "late" not in eng._prefixes
    finally:
        api.stop()


# -- the HTTP cases of tests/test_serving_hardening.py -----------------------

@pytest.fixture(scope="module")
def hardening():
    return port_tiny(**HARDENING)


def test_scheduler_isolates_bad_submission(hardening):
    """A malformed submit fails only its own client; a concurrent healthy
    request completes."""
    api, httpd, _ = start_server(serve, port_continuous(*hardening, max_batch=2))
    try:
        good = {}

        def ok():
            good["toks"] = api.submit([3, 1, 4], max_new_tokens=4, timeout=60)

        th = threading.Thread(target=ok)
        th.start()
        with pytest.raises(RuntimeError, match="engine error"):
            api.submit([5, 6], max_new_tokens=4, timeout=10, bogus_knob=True)
        th.join(timeout=60)
        assert good["toks"] is not None and len(good["toks"]) == 4
    finally:
        stop_server(api, httpd)


def test_v1_null_params_use_defaults(hardening):
    """Explicit JSON null takes the OpenAI defaults (max_tokens 16)."""
    api, httpd, port = start_server(serve, port_continuous(*hardening, max_batch=2))
    try:
        status, out = http_post(port, "/v1/completions", {
            "prompt": [3, 1, 4], "max_tokens": None, "temperature": None, "top_p": None,
            "repetition_penalty": None})
        assert status == 200
        assert len(out["choices"][0]["tokens"]) == 16
    finally:
        stop_server(api, httpd)


# -- the port's own rules ------------------------------------------------------

CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def test_cuda_error_fails_everything_after_it_fast(tiny):
    """A tick that raises a CUDA error loses the device: the request in
    flight fails with the error's text, and so does every later request and
    prefix registration, at once and without a tick (the engine is never
    driven again), while /health answers 503 with the text."""
    eng = _engine(tiny)
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        raise RuntimeError(CUDA_FAULT)

    eng.step = poisoned
    api, httpd, port = start_server(serve, eng)
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            api.submit([1, 2, 3], max_new_tokens=4, timeout=30)
        assert api.fatal == f"RuntimeError: {CUDA_FAULT}"
        ticks = calls["n"]
        t0 = time.perf_counter()
        for _ in range(3):
            with pytest.raises(RuntimeError, match="illegal memory access"):
                api.submit([4, 5], max_new_tokens=4, timeout=30)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            api.register_prefix("p", [1, 2], timeout=30)
        status, out = http_post(port, "/generate", {"prompt": [1, 2], "max_new_tokens": 2})
        assert status == 400 and "illegal memory access" in out["error"]
        assert time.perf_counter() - t0 < 5.0
        assert calls["n"] == ticks
        status, health = http_get(port, "/health")
        assert status == 503 and health["ok"] is False
        assert "illegal memory access" in health["error"]
        assert not api._events and not api._results and not api._errors
    finally:
        stop_server(api, httpd)


@pytest.mark.parametrize("exc,lost", [
    (RuntimeError(CUDA_FAULT), True),
    (RuntimeError("int8_matmul: CUDA error 700 (an illegal memory access was encountered)"),
     True),
    (RuntimeError("injected device error"), False),
    (ValueError("prompt token ids must be in [0, 128)"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), False),
], ids=["torch", "port-kernel", "host", "value", "oom"])
def test_cuda_context_lost_reads_the_error(tiny, exc, lost):
    """Which tick errors lose the device: CUDA errors (torch's and the port's
    kernel launches' text), not host-side ones or an out-of-memory error; a
    CPU engine has no context to probe."""
    assert cuda_context_lost(_engine(tiny), exc) is lost


def test_engine_methods_run_from_a_plain_thread_after_a_tick(tiny):
    """cancel, drop_prefix and reset_slots called after a tick from a thread
    whose grad mode is the default (not inference mode), and the loop
    thread itself in inference mode: the engine keeps working."""
    eng = _engine(tiny)
    eng.register_prefix("p", [1, 2, 3, 4])
    eng.submit("a", [1, 2, 3, 4, 9], max_new_tokens=20, prefix="p", repetition_penalty=1.3)
    eng.submit("b", [5, 6, 7], max_new_tokens=20, repetition_penalty=1.2)
    eng.step()
    eng.step()
    assert any(r is not None for r in eng.slot_req)
    seen = {}

    def plain():
        try:
            seen["mode"] = torch.is_inference_mode_enabled()
            seen["cancel"] = eng.cancel("a")
            eng.drop_prefix("p")
            eng.reset_slots()
        except Exception as e:  # reported below
            seen["error"] = e

    th = threading.Thread(target=plain)
    th.start()
    th.join(timeout=30)
    assert "error" not in seen, seen.get("error")
    assert seen["mode"] is False and seen["cancel"] is True
    assert "p" not in eng._prefixes and all(r is None for r in eng.slot_req)
    api = ServingAPI(eng)
    modes = []
    step = eng.step

    def recording():
        modes.append(torch.is_inference_mode_enabled())
        return step()

    eng.step = recording
    api.start()
    try:
        assert len(api.submit([5, 6, 7], max_new_tokens=5, timeout=60)) == 5
    finally:
        api.stop()
    assert modes and all(modes)
