"""The port's ``serve`` against the JAX package's, on the same weights (JAX
``init_params``, float and W8A8 at ``tests/test_api.py``'s width, carried
across by ``params_from_jax``; f32 compute and KV on both sides) and the
same requests, sent one at a time to every route.

Greedy tokens must be equal; a W8A8 row may part only at a step where the
JAX model's top-2 logit margin is at most 0.02 (the repo's near-tie rule).
Where the tokens agree, the JSON replies must be equal apart from ``id`` and
``created``, with logprobs (f32) within 1e-4. A streamed reply is held by
its streamed tokens and its closing events (where the chunks break depends
on when the handler polls). Both ``/stats`` carry the same keys. Sampled
requests are checked on the port for their shape only: its
``torch.Generator`` draws other numbers than JAX's key by design."""

import json

import numpy as np
import pytest

from test_torch_util import (API_TINY, ToyTok, http_get, http_post, http_stream, port_config,
                             port_qcfg, start_server, stop_server, to_numpy_tree)

NEAR_TIE = 0.02
LOGPROB_ATOL = 1e-4
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 7, 7], [12, 55, 3, 99, 101, 17, 8, 42, 5, 66, 31]]


def _arm(name):
    """(JAX module, JAX cfg, JAX params, JAX qcfg, port params, port cfg,
    port qcfg) of the float or W8A8 arm."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax

    cfg = JL.LlamaConfig(**API_TINY)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    qcfg = None
    if name == "w8a8":
        ids = jnp.asarray(np.random.default_rng(0).integers(0, 128, size=(2, 32)), jnp.int32)
        _, _, stats = JL.forward_jit(params, ids, cfg, capture_stats=True)
        qcfg = JQ(type="int8")
        params = JL.quantize(params, qcfg, JL.layer_scales(stats))
    return (JL, cfg, params, qcfg, params_from_jax(to_numpy_tree(params), device="cpu"),
            port_config(cfg), port_qcfg(qcfg))


@pytest.fixture(scope="module", params=["float", "w8a8"])
def servers(request):
    """{"jax": port, "port": port} of two servers on one arm's weights."""
    import jax.numpy as jnp
    import torch
    from autosmoothquant_tpu.serve.api import serve as jserve
    from autosmoothquant_tpu.serve.batching import ContinuousEngine as JC
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.serve.api import serve as tserve
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine as TC

    JL, cfg, params, qcfg, tparams, tcfg, tq = _arm(request.param)
    kw = dict(max_batch=2, max_seq=64)
    je = JC(JL, params, cfg, qcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    te = TC(TL, tparams, tcfg, tq, kv_dtype=torch.float32, compute_dtype=torch.float32,
            device="cpu", **kw)
    started = {"jax": start_server(jserve, je, tokenizer=ToyTok(), model_id="tiny"),
               "port": start_server(tserve, te, tokenizer=ToyTok(), model_id="tiny")}

    def margin(ids):
        import jax.numpy as jnp

        h = JL.forward_jit(params, jnp.asarray([ids], jnp.int32), cfg, qcfg)[0]
        top = np.sort(np.asarray(JL.logits(params, h))[0, -1])[-2:]
        return float(top[1] - top[0])

    yield {k: v[2] for k, v in started.items()}, margin
    for api, httpd, _ in started.values():
        stop_server(api, httpd)


def _tokens_agree(prompt, jt, tt, margin):
    """True where the greedy tokens are equal; a parting passes only at a
    JAX near-tie (then False: the rest of the reply is not compared)."""
    if jt == tt:
        return True
    j = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b), min(len(jt), len(tt)))
    m = margin(prompt + jt[:j])
    assert m <= NEAR_TIE, f"tokens part at step {j} at a JAX top-2 margin of {m}"
    return False


def _same(a, b, path="reply"):
    """JSON equality apart from id and created; floats within LOGPROB_ATOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            if k not in ("id", "created"):
                _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= LOGPROB_ATOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _both(ports, method, path, payload=None):
    call = {"post": lambda p: http_post(p, path, payload),
            "get": lambda p: http_get(p, path),
            "stream": lambda p: http_stream(p, path, payload)}[method]
    return call(ports["jax"]), call(ports["port"])


def _greedy(ports, prompt, n):
    """The JAX server's greedy tokens: where stop and eos cases cut."""
    status, out = http_post(ports["jax"], "/generate", {"prompt": prompt, "max_new_tokens": n})
    assert status == 200
    return out["tokens"]


def _cut(case, free):
    """A case's request fields, its stop / eos taken from the free tokens
    so that they end the reply early."""
    return {"greedy": {}, "logprobs": {"logprobs": True},
            "stop": {"stop": [free[3:5]]}, "eos": {"eos_token_id": free[5]},
            "stop_token": {"stop": [[free[4]]]}}[case]


@pytest.mark.parametrize("case", ["greedy", "logprobs", "stop", "eos"])
def test_generate(servers, case):
    ports, margin = servers
    for prompt in PROMPTS:
        body = {"prompt": prompt, "max_new_tokens": 10,
                **_cut(case, _greedy(ports, prompt, 10))}
        (sj, j), (st, t) = _both(ports, "post", "/generate", body)
        assert sj == st == 200
        if _tokens_agree(prompt, j["tokens"], t["tokens"], margin):
            _same(j, t)
            assert len(t["tokens"]) < 10 or case in ("greedy", "logprobs")


def test_generate_stream(servers):
    ports, margin = servers
    for prompt in PROMPTS:
        j, t = _both(ports, "stream", "/generate",
                     {"prompt": prompt, "max_new_tokens": 9, "logprobs": True, "stream": True})
        done = {k: json.loads(ev[-1][1]) for k, ev in (("jax", j), ("port", t))}
        assert j[-1][0] == t[-1][0] == "done"
        if not _tokens_agree(prompt, done["jax"]["tokens"], done["port"]["tokens"], margin):
            continue
        _same(done["jax"], done["port"])
        streamed = [t for ev, d in t[:-1] for t in json.loads(d)["tokens"]]
        assert streamed == done["port"]["tokens"][:len(streamed)]


@pytest.mark.parametrize("case", ["greedy", "logprobs", "stop_token"])
def test_completions(servers, case):
    ports, margin = servers
    for prompt in PROMPTS:
        cut = _cut(case, _greedy(ports, prompt, 8))
        body = {"prompt": prompt, "max_tokens": 8, "temperature": 0.0,
                **({"logprobs": 1, "echo": True} if case == "logprobs" else cut)}
        (sj, j), (st, t) = _both(ports, "post", "/v1/completions", body)
        assert sj == st == 200
        if _tokens_agree(prompt, j["choices"][0]["tokens"], t["choices"][0]["tokens"], margin):
            _same(j, t)
            assert t["choices"][0]["finish_reason"] == ("stop" if cut.get("stop") else "length")


def test_completions_batch_and_text(servers):
    """A batch of token prompts with n = 2, and a text prompt (ToyTok)."""
    ports, _ = servers
    (sj, j), (st, t) = _both(ports, "post", "/v1/completions", {
        "prompt": PROMPTS[:2], "n": 2, "max_tokens": 5, "temperature": 0.0})
    assert sj == st == 200
    _same(j, t)
    (sj, j), (st, t) = _both(ports, "post", "/v1/completions", {
        "prompt": "hello", "max_tokens": 4, "temperature": 0.0, "echo": True})
    assert sj == st == 200
    _same(j, t)


def test_completions_stream(servers):
    ports, margin = servers
    body = {"max_tokens": 7, "temperature": 0.0, "logprobs": 1, "stream": True,
            "stream_options": {"include_usage": True}}
    for prompt in PROMPTS:
        j, t = _both(ports, "stream", "/v1/completions", {"prompt": prompt, **body})
        assert j[-1][1] == t[-1][1] == "[DONE]"
        chunks = {k: [json.loads(d) for _, d in ev[:-1]] for k, ev in (("jax", j), ("port", t))}
        toks = {k: [x for c in cs[:-1] for x in c["choices"][0]["tokens"]]
                for k, cs in chunks.items()}
        if not _tokens_agree(prompt, toks["jax"], toks["port"], margin):
            continue
        _same(chunks["jax"][-1], chunks["port"][-1])   # the usage chunk
        finish = {k: cs[-2]["choices"][0]["finish_reason"] for k, cs in chunks.items()}
        assert finish["jax"] == finish["port"] == "length"


def test_chat(servers):
    ports, _ = servers
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    (sj, j), (st, t) = _both(ports, "post", "/v1/chat/completions",
                             {"messages": msgs, "max_tokens": 5, "temperature": 0.0})
    assert sj == st == 200
    _same(j, t)
    j, t = _both(ports, "stream", "/v1/chat/completions",
                 {"messages": msgs, "max_tokens": 5, "temperature": 0.0, "stream": True})
    text = {k: "".join(json.loads(d)["choices"][0]["delta"].get("content", "")
                       for _, d in ev[:-1]) for k, ev in (("jax", j), ("port", t))}
    assert text["jax"] == text["port"]
    _same(json.loads(j[-2][1]), json.loads(t[-2][1]))


def test_prefix_route(servers):
    ports, margin = servers
    sys_prompt = [11, 22, 33, 44, 55, 66, 77, 88, 99, 100]
    (sj, j), (st, t) = _both(ports, "post", "/prefix", {"id": "sys", "tokens": sys_prompt})
    assert sj == st == 200
    _same(j, t)
    prompt = sys_prompt + [5, 6, 7]
    (sj, j), (st, t) = _both(ports, "post", "/generate",
                             {"prompt": prompt, "max_new_tokens": 6, "prefix": "sys"})
    assert sj == st == 200
    if _tokens_agree(prompt, j["tokens"], t["tokens"], margin):
        _same(j, t)
    (sj, j), (st, t) = _both(ports, "post", "/prefix", {"id": "sys", "drop": True})
    assert sj == st == 200
    _same(j, t)


def test_utility_routes(servers):
    ports, _ = servers
    for path, body in (("/tokenize", {"text": "hello"}), ("/detokenize", {"tokens": [72, 71]}),
                       ("/tokenize", {"text": 7}), ("/generate", {"prompt": []}),
                       ("/v1/completions", {"prompt": []}),
                       ("/v1/chat/completions", {"messages": []}), ("/prefix", {"tokens": [1]})):
        (sj, j), (st, t) = _both(ports, "post", path, body)
        assert sj == st, path
        _same(j, t, path)
    for path in ("/v1/models", "/nope"):
        (sj, j), (st, t) = _both(ports, "get", path)
        assert sj == st, path
        _same(j, t, path)
    (sj, j), (st, t) = _both(ports, "get", "/stats")
    assert sj == st == 200 and set(j) == set(t)


def test_sampled_shape(servers):
    """Sampled replies: the port's shape only (its generator is its own)."""
    ports, _ = servers
    status, t = http_post(ports["port"], "/generate", {
        "prompt": PROMPTS[0], "max_new_tokens": 6, "temperature": 0.9, "top_k": 10,
        "top_p": 0.9, "logprobs": True})
    assert status == 200 and set(t) == {"tokens", "text", "logprobs"}
    assert len(t["tokens"]) == len(t["logprobs"]) == 6
    assert all(lp <= 0.0 for lp in t["logprobs"])
    status, t = http_post(ports["port"], "/v1/completions",
                          {"prompt": PROMPTS[1], "max_tokens": 5, "n": 2})
    assert status == 200
    assert [len(c["tokens"]) for c in t["choices"]] == [5, 5]
