"""Shared helpers (no tests) of the tests that hold the PyTorch port against
the JAX package: tiny Llama and OPT configs, JAX-built params, a prefill +
one decode step through either package, the card fixture."""

import dataclasses

import numpy as np
import pytest

TINY = dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256)
SCALE_KEYS = ("attn_input_scale", "q_output_scale", "k_output_scale",
              "v_output_scale", "out_input_scale", "gate_input_scale",
              "down_input_scale")


def jax_llama(qcfg_kwargs=None, seed=0, **overrides):
    """(JAX llama module, cfg, params) — float, or int8 quantized with the
    layer scales a calibration pass over random ids measures. ``overrides``
    set config fields (the variants: attention_bias, sliding_window,
    hidden_act); q/k/v biases are redrawn with std 0.5, large enough to move
    the logits (init_params draws std 0.02)."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    cfg = JL.LlamaConfig(**{**TINY, **overrides})
    params = JL.init_params(cfg, jax.random.PRNGKey(seed))
    if cfg.attention_bias:
        rng = np.random.default_rng(seed)
        attn = {k: ({**p, "bias": jnp.asarray(0.5 * rng.normal(size=p["bias"].shape),
                                              jnp.float32)} if "bias" in p else p)
                for k, p in params["layers"]["attn"].items()}
        params = {**params, "layers": {**params["layers"], "attn": attn}}
    if qcfg_kwargs is None:
        return JL, cfg, params, None
    ids = jnp.asarray(np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(2, 32)), jnp.int32)
    _, _, stats = JL.forward_jit(params, ids, cfg, capture_stats=True)
    scales = JL.layer_scales(stats)
    qcfg = JQ(**qcfg_kwargs)
    return JL, cfg, JL.quantize(params, qcfg, scales), qcfg


TINY_OPT = dict(vocab_size=256, hidden_size=128, word_embed_proj_dim=128,
                ffn_dim=256, num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128)


def jax_opt(qcfg_kwargs=None, seed=0, **overrides):
    """(JAX opt module, cfg, params, qcfg). Float params keep init_params'
    zero biases (the JAX float path reads no "b"). Quantized params are
    drawn with nonzero linear biases and LayerNorm weights and biases first
    (init_params draws ones and zeros, which would leave the bias epilogue
    and beta untested), then quantized with the layer scales a calibration
    pass measures."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.models import opt as JO
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    cfg = JO.OPTConfig(**{**TINY_OPT, **overrides})
    params = JO.init_params(cfg, jax.random.PRNGKey(seed))
    if qcfg_kwargs is None:
        return JO, cfg, params, None
    rng = np.random.default_rng(seed)

    def rand(like, scale, offset=0.0):
        return jnp.asarray(offset + scale * rng.normal(size=like.shape), jnp.float32)

    lay = params["layers"]
    layers = {
        "ln1": {"w": rand(lay["ln1"]["w"], 0.2, 1.0), "b": rand(lay["ln1"]["b"], 0.2)},
        "ln2": {"w": rand(lay["ln2"]["w"], 0.2, 1.0), "b": rand(lay["ln2"]["b"], 0.2)},
        "attn": {k: {**v, "b": rand(v["b"], 0.1)} for k, v in lay["attn"].items()},
        "mlp": {k: {**v, "b": rand(v["b"], 0.1)} for k, v in lay["mlp"].items()},
    }
    params = {**params, "layers": layers,
              "final_norm": {"w": rand(params["final_norm"]["w"], 0.2, 1.0),
                             "b": rand(params["final_norm"]["b"], 0.2)}}
    qcfg = JQ(**qcfg_kwargs)
    scales = None
    if qcfg.is_int8:
        ids = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 32)), jnp.int32)
        _, _, stats = JO.forward_jit(params, ids, cfg, capture_stats=True)
        scales = JO.layer_scales(stats)
    return JO, cfg, JO.quantize(params, qcfg, scales, cfg), qcfg


def mixtral_state_dict():
    """A one-layer HF Mixtral state dict of 2 experts (hidden 8, intermediate
    16, 2 heads): what the float mapper reads."""
    import torch

    rng = np.random.default_rng(0)
    sd = {"model.embed_tokens.weight": rng.normal(size=(32, 8)),
          "model.norm.weight": np.ones(8), "lm_head.weight": rng.normal(size=(32, 8)),
          "model.layers.0.input_layernorm.weight": np.ones(8),
          "model.layers.0.post_attention_layernorm.weight": np.ones(8),
          "model.layers.0.block_sparse_moe.gate.weight": rng.normal(size=(2, 8))}
    for n in ("q", "k", "v", "o"):
        sd[f"model.layers.0.self_attn.{n}_proj.weight"] = rng.normal(size=(8, 8))
    for e in range(2):
        for w, shape in (("w1", (16, 8)), ("w3", (16, 8)), ("w2", (8, 16))):
            sd[f"model.layers.0.block_sparse_moe.experts.{e}.{w}.weight"] = rng.normal(size=shape)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def port_opt_config(cfg):
    from autosmoothquant_tpu_torch.models.opt import OPTConfig

    return OPTConfig(**dataclasses.asdict(cfg))


S_MAX = 64  # cache slots of run_jax_cached / run_port_cached


def _pads(b, pad_starts):
    return np.zeros(b, np.int32) if pad_starts is None else np.asarray(pad_starts)


def _decode_positions(b, t, pad_starts):
    return (t - _pads(b, pad_starts))[:, None].astype(np.int32)


def _decode_valid(b, t, pad_starts):
    """kv_valid after the decode slot t is marked: [pad_b, t] per row (the
    Engine's mask; pad slots hold what the pad rows computed, which the
    flash kernels and the eager path compute differently)."""
    col = np.arange(S_MAX)[None, :]
    return (col >= _pads(b, pad_starts)[:, None]) & (col <= t)


def run_jax_cached(JM, cfg, params, qcfg, ids, kv_dtype, pad_starts=None,
                   positions=None):
    """A JAX family module's prefill logits [B, T, V], one greedy decode
    step's logits [B, V] and the token it decoded [B], f32 compute."""
    import jax
    import jax.numpy as jnp

    b, t = ids.shape

    @jax.jit
    def prefill(params, ids, cache):
        h, cache, _ = JM.forward(params, ids, cfg, qcfg, kv_cache=cache,
                                 cache_index=0, pad_starts=pad_starts,
                                 positions=positions, compute_dtype=jnp.float32)
        return JM.logits(params, h), cache

    @jax.jit
    def decode(params, tok, cache, pos, valid):
        h, _, _ = JM.forward(params, tok[:, None], cfg, qcfg, kv_cache=cache,
                             cache_index=t, kv_valid=valid, positions=pos,
                             compute_dtype=jnp.float32)
        return JM.logits(params, h)[:, 0]

    cache = JM.init_kv_cache(cfg, b, S_MAX, kv_dtype)
    lg, cache = prefill(params, jnp.asarray(ids), cache)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    pos = jnp.asarray(_decode_positions(b, t, pad_starts))
    valid = jnp.asarray(_decode_valid(b, t, pad_starts))
    return (np.asarray(lg), np.asarray(decode(params, tok, cache, pos, valid)),
            np.asarray(tok))


def run_port_cached(TM, cfg, params, qcfg, ids, kv_dtype, tok, pad_starts=None,
                    positions=None):
    """The port's prefill logits and the logits of the decode step that
    feeds ``tok`` (the JAX side's token), on the CPU."""
    import torch

    b, t = ids.shape
    cache = TM.init_kv_cache(cfg, b, S_MAX, kv_dtype, "cpu")
    ps = None if pad_starts is None else torch.from_numpy(np.asarray(pad_starts))
    pos = None if positions is None else torch.from_numpy(np.asarray(positions))
    with torch.inference_mode():
        h, cache = TM.forward(params, torch.from_numpy(ids).long(), cfg, qcfg,
                              kv_cache=cache, cache_index=0, pad_starts=ps,
                              positions=pos, compute_dtype=torch.float32)
        lg = TM.logits(params, h)
        h, _ = TM.forward(params, torch.from_numpy(tok.copy()).long()[:, None],
                          cfg, qcfg, kv_cache=cache, cache_index=t,
                          kv_valid=torch.from_numpy(_decode_valid(b, t, pad_starts)),
                          positions=torch.from_numpy(_decode_positions(b, t, pad_starts)),
                          compute_dtype=torch.float32)
        return lg.numpy(), TM.logits(params, h)[:, 0].numpy()


def to_numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def port_config(cfg):
    from autosmoothquant_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**dataclasses.asdict(cfg))


def port_qcfg(qcfg):
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    return None if qcfg is None else QuantConfig.from_dict(qcfg.to_dict())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one torch thread for a whole module (autouse where
    a test module imports it): the tiny models issue many small ops whose
    thread pool spins against the suite's other workers (an engine test of
    0.4 s alone took 90 s among them); one thread also fixes each CPU sum's
    order on any machine."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time,
    never while the module is collected)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# continuous batching: the JAX and the port ContinuousEngine on one arm's
# params (tests/test_torch_batching*.py)

ARMS = ("float", "int8", "opt_int8")
MAX_SEQ = 128  # TINY_OPT's max_position_embeddings bounds the OPT arm
KV = ("f32", "int8")


def _kv_dtypes(kv):
    import jax.numpy as jnp
    import torch

    return {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]


def batching_models():
    """arm -> (JAX module, cfg, params, port module, port cfg, port params,
    qcfgs (JAX, port)), built once per arm (a module fixture returns it).
    ``.jax_engines`` keeps the JAX engines by configuration: each compiles
    its own steps, and an idle engine serves the next request set as a new
    one would (its counters are read as differences)."""
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import opt as TO

    built = {}

    def get(arm):
        if arm not in built:
            if arm == "opt_int8":
                JM, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=21)
                TM, tcfg = TO, port_opt_config(cfg)
            else:
                JM, cfg, params, qcfg = jax_llama({"type": "int8"} if arm == "int8" else None,
                                                  seed=21)
                TM, tcfg = TL, port_config(cfg)
            built[arm] = (JM, cfg, params, TM, tcfg,
                          params_from_jax(to_numpy_tree(params), device="cpu"),
                          (qcfg, port_qcfg(qcfg)))
        return built[arm]
    get.jax_engines = {}
    return get


def port(models, arm, kv="f32", **kw):
    """A port ContinuousEngine on the arm's params (CPU, f32 compute)."""
    import torch
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine

    *_, TM, tcfg, tparams, (_, tq) = models(arm)
    kw = {"max_batch": 2, "max_seq": MAX_SEQ, **kw}
    return ContinuousEngine(TM, tparams, tcfg, tq, kv_dtype=_kv_dtypes(kv)[1],
                            compute_dtype=torch.float32, device="cpu", **kw)


def pair(models, arm, kv="f32", **kw):
    """A JAX ContinuousEngine (an idle one of this configuration, where one
    was built) and a new port one on the arm's params."""
    import jax.numpy as jnp
    from autosmoothquant_tpu.serve.batching import ContinuousEngine

    key = (arm, kv, tuple(sorted(kw.items())))
    je = models.jax_engines.get(key)
    if je is None:
        JM, cfg, params, *_, (jq, _) = models(arm)
        je = models.jax_engines[key] = ContinuousEngine(
            JM, params, cfg, jq, kv_dtype=_kv_dtypes(kv)[0], compute_dtype=jnp.float32,
            **{"max_batch": 2, "max_seq": MAX_SEQ, **kw})
    return je, port(models, arm, kv, **kw)


def _counts(e):
    return e.prefill_tokens_processed, e.decode_tokens_generated


def run_both(je, te, reqs):
    """Run a request set, [(uid, prompt, submit kwargs)], through both
    engines: equal outputs, equal counter increments, and logprobs (where
    asked) within atol 1e-4. Returns the port's outputs."""
    before = _counts(te), _counts(je)
    treqs = [te.submit(uid, p, **kw) for uid, p, kw in reqs]
    jreqs = [je.submit(uid, p, **kw) for uid, p, kw in reqs]
    got, want = te.run(), je.run()
    assert got == want
    assert ([a - b for a, b in zip(_counts(te), before[0])]
            == [a - b for a, b in zip(_counts(je), before[1])])
    for t, j in zip(treqs, jreqs):
        assert t.done and j.done
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4, rtol=0)
    return got


def prompts_of(seed, lengths, hi=250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, hi, size=n).tolist() for n in lengths]


# HTTP helpers of the serving tests (tests/test_torch_api*.py,
# test_torch_openai_api.py, test_torch_cli.py); every call has a timeout

API_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=128)


def port_tiny(seed=0, **shape):
    """(port llama module, port cfg, f32 params on the CPU) drawn by the
    bench arm's ``draw_float`` (N(0, 1/K) weights) at ``shape`` (default
    API_TINY): the facade's tests need the port's engine, not JAX's weights."""
    import torch
    from autosmoothquant_tpu_torch.bench import draw_float
    from autosmoothquant_tpu_torch.models import llama as TL

    cfg = TL.LlamaConfig(**(shape or API_TINY))
    return TL, cfg, draw_float(cfg, seed, "cpu", proj_dtype=torch.float32)


def port_continuous(TL, cfg, params, qcfg=None, **kw):
    """A port ContinuousEngine on the CPU in f32 (max_batch 4, max_seq 64
    unless given)."""
    import torch
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine

    kw = {"max_batch": 4, "max_seq": 64, **kw}
    return ContinuousEngine(TL, params, cfg, qcfg, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, device="cpu", **kw)


def start_server(serve, eng, **kw):
    """``serve(eng, port=0, **kw)`` with its HTTP loop on a daemon thread:
    (api, httpd, port). Stop with ``stop_server(api, httpd)``."""
    import threading

    api, httpd = serve(eng, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return api, httpd, httpd.server_address[1]


def stop_server(api, httpd):
    httpd.shutdown()
    api.stop()
    httpd.server_close()


def http_post(port, path, payload, timeout=120):
    """(status, JSON reply) of a POST."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(port, path, timeout=30):
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_stream(port, path, payload, timeout=120):
    """The ``data:`` payloads of an SSE reply, in order, as (event, data
    string) pairs (event "data" where the block names none)."""
    import json
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        body = r.read().decode()
    out = []
    for block in body.strip().split("\n\n"):
        lines = dict(line.split(": ", 1) for line in block.split("\n") if ": " in line)
        out.append((lines.get("event", "data"), lines["data"]))
    return out


class ToyTok:
    """Char-level round-trip tokenizer (printable ASCII -> ids 2..97), the
    one of tests/test_openai_api.py."""

    class _Enc(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text):
        return self._Enc((ord(ch) - 32) % 96 + 2 for ch in text)

    def decode(self, ids):
        return "".join(chr((i - 2) % 96 + 32) for i in ids)


def verify_write_census(eng, active_row, gamma):
    """Run one prompt-lookup verify of ``gamma`` drafts on a speculative
    ContinuousEngine or PagedEngine (its graph on the card) with every row
    parked but ``active_row``, which sits at the last length a verify may
    run at (lens + gamma + 1 = max_seq - 1), its pages allocated on a
    paged engine; the pool's first layer's K zeroed first. Returns (the
    written flat slots of each row, the pool's slot count, the scratch
    slots' bound: the first slot no parked write may reach)."""
    import torch

    b = eng.max_batch
    active = np.zeros(b, bool)
    active[active_row] = True
    lens = eng.max_seq - gamma - 2
    eng.lens[:] = 0
    eng.lens[active_row] = lens
    eng.pending_tok[:] = 1
    paged = hasattr(eng, "block_size")
    if paged:
        eng._set_row(active_row, eng._alloc(eng.blocks_per_slot))
    k = eng.pool.k[0] if paged else eng.pool[0].k
    k.zero_()
    torch.manual_seed(0)
    eng._spec_in[:, :gamma + 1].copy_(torch.randint(1, eng.cfg.vocab_size, (b, gamma + 1)))
    lens_dec = eng._load_rows(active)
    eng._graphs.run(("verify", gamma), lambda: eng._verify(gamma), 1)
    written = k.reshape(-1, *k.shape[-2:]).abs().amax(dim=(-1, -2)).cpu() > 0
    rows = {}
    for r in range(b):
        pos = torch.tensor(lens_dec[r]).long() + torch.arange(gamma + 1)
        if paged:
            from autosmoothquant_tpu_torch.models.common import paged_slots

            slots = paged_slots(eng.pool.table.cpu()[r:r + 1], pos[None], eng.block_size)
        else:
            slots = r * k.shape[1] + pos
        rows[r] = slots.tolist()
    bound = eng.scratch_pages * eng.block_size if paged else None
    if paged:
        eng._release_row(active_row)
    return rows, written, bound


def check_verify_writes(eng, gamma):
    """For each row in turn the one active row, the others parked
    (:func:`verify_write_census`): the slots written are exactly the rows'
    own, no two rows share one, a parked row writes only past max_seq in its
    own row (contiguous) or inside the scratch pages (paged), and the
    active row only below max_seq, in its own pages."""
    for active_row in range(eng.max_batch):
        rows, written, bound = verify_write_census(eng, active_row, gamma)
        flat = [x for r in rows.values() for x in r]
        assert len(set(flat)) == len(flat) == eng.max_batch * (gamma + 1)
        assert set(np.flatnonzero(written.numpy()).tolist()) == set(flat)
        s = eng.max_seq
        for r, slots in rows.items():
            if bound is not None:
                assert all((x < bound) == (r != active_row) for x in slots)
            else:
                size = written.numel() // eng.max_batch
                assert all(r * size <= x < (r + 1) * size for x in slots)
                assert all((x - r * size >= s) == (r != active_row) for x in slots)
