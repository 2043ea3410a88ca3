"""The Mixtral family of the port (``models/mixtral.py``, the router's
``kernels/moe.py``) against the JAX package's, on the CPU, on tiny models: 2
layers, hidden 64, 4 query heads of 16 on 2 kv heads, 4 experts of
intermediate 96, top 2 (the config of tests/test_mixtral.py), float weights
from JAX's ``init_params``.

JAX's route rule is the port's: the sparse (capacity-bucketed) route at T >=
4 E = 16 tokens, the dense route below; the JAX side forces its mode as
tests/test_mixtral_sparse.py does (``runtime.override(moe=...)``), so each
case names the route both sides take. Where JAX runs a dense step of T <= 8
rows in W8A8 or fp8 e4m3 dynamic, the port runs its routed route, the dense
route's bits from the picked experts alone (tests/test_torch_moe_routed.py).

Tolerances (max |port - JAX|): logits in every format rtol 2e-4 / atol 2e-4,
the JAX suite's own dense-against-sparse bar (measured: float 5e-7, int8
1.8e-6, fp8 and int4 3e-7; a last-bit difference in an f32 sum that put an
activation across an int8 or fp8 rounding boundary would move a logit by
~1e-3). Expert projections at the block level: int8 activations, int32
accumulators and outputs bit-equal; fp8 (JAX: a bf16 dot with an f32 sum,
the port: K4's plain version) and int4 within 1e-5 relative. Statistics
rtol 1e-5; scales and quantized leaves bit-equal on equal inputs; smoothing
within 2^-21 (tests/test_torch_quantize.py). Dispatch tables equal; overflow
dropped exactly as JAX drops it. Greedy tokens equal to JAX's Engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu import runtime as jrt
from autosmoothquant_tpu.models import mixtral as JM
from autosmoothquant_tpu.quant.config import QuantConfig as JQ
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import mixtral as TM
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_quantize import assert_bit_equal, leaves
from test_torch_util import (one_torch_thread, run_jax_cached,  # noqa: F401
                             run_port_cached, to_numpy_tree)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, max_position_embeddings=128, rms_norm_eps=1e-5,
            rope_theta=10000.0)
TOL = dict(rtol=2e-4, atol=2e-4)
QUANT = {
    "float": None,
    "int8": {"type": "int8"},
    # mixed granularity (BASELINE config 3's recipe)
    "int8_mixed": {"type": "int8", "qkv": "per-tensor", "out": "per-token",
                   "fc1": "per-tensor", "fc2": "per-token"},
    "int8_per_token": {"type": "int8", "qkv": "per-token", "out": "per-token",
                       "fc1": "per-token", "fc2": "per-token"},
    "fp8_e4m3": {"type": "fp8_e4m3"},
    "fp8_e4m3_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
    "int4": {"type": "int4", "group_size": 16},
}


def _cfgs():
    return JM.MixtralConfig(**TINY), TM.MixtralConfig(**TINY)


def _batches(n=2, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], size=(2, 32)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """get(quant) -> (JAX cfg, port cfg, JAX params, port params, JAX qcfg,
    port qcfg, JAX all-experts float statistics); int8 quantizes the
    smoothed model with the layer scales of those statistics."""
    from autosmoothquant_tpu.calibrate.calibrate import calibrate as jcal

    built = {}
    cfg, tcfg = _cfgs()
    jp0 = jax.jit(JM.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    stats = jcal(JM, jp0, cfg, iter(_batches()), extra_forward_kwargs=JM.CALIBRATION_FORWARD_KWARGS)

    def get(quant="float"):
        if quant not in built:
            jp = jp0
            qkw = QUANT[quant]
            qcfg = None if qkw is None else JQ(**qkw)
            if qcfg is not None:
                src = JM.smooth(jp, stats, 0.5, cfg=cfg) if qcfg.is_int8 else jp
                jp = JM.quantize(src, qcfg, JM.layer_scales(stats), cfg=cfg)
            built[quant] = (cfg, tcfg, jp, params_from_jax(to_numpy_tree(jp), tcfg, device="cpu"),
                            qcfg, None if qkw is None else TQ(**qkw), stats)
        return built[quant]
    return get


def _t(x):
    return torch.from_numpy(np.array(x))


# --- config, registry, params


def test_config_and_registry():
    from autosmoothquant_tpu_torch.models.registry import get_model_family

    hf = {"architectures": ["MixtralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
          "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
          "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6}
    assert get_model_family(hf) is TM and TM.FAMILY == "mixtral"
    assert get_model_family({"model_type": "mixtral"}) is TM
    assert get_model_family({"architectures": ["QuantizedMixtralForCausalLM"]}) is TM
    assert get_model_family({"architectures": ["Int8MixtralForCausalLM"]}) is TM
    cfg = TM.config_from_hf(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JM.MixtralConfig.from_hf(hf))
    assert cfg == TM.MixtralConfig() and cfg.head_dim == 128
    assert TM.CALIBRATION_FORWARD_KWARGS == JM.CALIBRATION_FORWARD_KWARGS
    assert TM.STAT_KEYS == JM.STAT_KEYS and TM.HF_PROJ_NAMES == JM.HF_PROJ_NAMES


def test_init_params_layout():
    """The port's own random params: the layout forward reads (experts
    [E, in, out], the router [D, E]), and a forward through them."""
    _, tcfg = _cfgs()
    params = TM.init_params(tcfg, seed=3, device="cpu")
    moe = params["layers"][1]["moe"]
    assert moe["router"]["w"].shape == (64, 4)
    assert moe["w1"]["w"].shape == (4, 64, 96) and moe["w2"]["w"].shape == (4, 96, 64)
    h, _ = TM.forward(params, torch.arange(20)[None], tcfg)
    assert TM.logits(params, h).shape == (1, 20, 256)


# --- routing and dispatch (tests/test_mixtral_sparse.py)


@pytest.mark.parametrize("T,E,K,factor", [(16, 4, 2, 2.0), (128, 8, 2, 2.0), (1, 8, 2, 2.0),
                                          (32, 4, 2, 1.0), (100, 8, 2, 1.25)])
def test_capacity_matches_jax(T, E, K, factor):
    assert TM.expert_capacity(T, E, K, factor) == JM.expert_capacity(T, E, K, factor)


def _top(T, E, K, seed):
    """Distinct experts a token (as top_k gives them) and random weights."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    return idx, rng.random((T, K)).astype(np.float32)


@pytest.mark.parametrize("T,E,K,factor", [(16, 4, 2, 2.0), (40, 8, 2, 1.0), (64, 4, 2, 2.0)])
def test_dispatch_tables_match_jax(T, E, K, factor):
    """gather equals JAX's, and JAX's combine weights wtab are top_w at the
    port's slots (0 at pad slots); every kept (token, k) pair sits once in
    its expert's bucket, at the flat slot ``slot`` names."""
    C = JM.expert_capacity(T, E, K, factor)
    idx, w = _top(T, E, K, T)
    jg, jw = JM._dispatch_indices(jnp.asarray(idx), jnp.asarray(w), T, E, K, C)
    g, slot = TM.dispatch_indices(torch.from_numpy(idx).long(), T, E, K, C)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    wt = np.zeros(E * C + 1, np.float32)
    wt[slot.numpy().reshape(-1)] = w.reshape(-1)
    np.testing.assert_array_equal(wt[:E * C].reshape(E, C), np.asarray(jw))
    flat = g.numpy().reshape(-1)
    for t in range(T):
        for k in range(K):
            s = int(slot[t, k])
            if s < E * C:
                assert flat[s] == t and s // C == idx[t, k]
            else:
                assert t not in g.numpy()[idx[t, k]]
    assert int(slot.max()) <= E * C


def test_overflow_drops_as_jax(models):
    """Every token on experts 0 and 1 at capacity factor 1: expert 0 and 1
    keep their first C tokens, the rest drop (written to the scratch column,
    never past a buffer), experts 2 and 3 are all pad; the block's output
    equals JAX's _moe_block_sparse with the same drops."""
    cfg, tcfg, params, tp, *_ = models()
    T, E, K = 32, cfg.num_local_experts, cfg.num_experts_per_tok
    C = JM.expert_capacity(T, E, K, 1.0)
    assert C < T
    idx = np.zeros((T, K), np.int32)
    idx[:, 1] = 1
    w = np.full((T, K), 0.5, np.float32)
    g, slot = TM.dispatch_indices(torch.from_numpy(idx).long(), T, E, K, C)
    jg, _ = JM._dispatch_indices(jnp.asarray(idx), jnp.asarray(w), T, E, K, C)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert (g[0] < T).sum() == C and (g[2:] == T).all()
    assert g.shape == (E, C) and int((slot == E * C).sum()) == 2 * (T - C)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    tmp = tp["layers"][0]["moe"]
    x = np.random.default_rng(3).normal(size=(T, cfg.hidden_size)).astype(np.float32)
    want = jax.jit(lambda x, w, i: JM._moe_block_sparse(x, lp["moe"], cfg, None, jnp.float32,
                                                        (w, i), capacity_factor=1.0))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx))
    got = TM.moe_sparse(torch.from_numpy(x), tmp, tcfg, None, torch.float32,
                        torch.from_numpy(w), torch.from_numpy(idx).long(), capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()


def test_route_matches_jax(models):
    """The router's f32 logits (kernels/moe.py's plain version), softmax, top
    2 and renormalization against JAX's on the same norm output."""
    cfg, tcfg, jp, tp, *_ = models()
    x = np.random.default_rng(4).normal(size=(24, 64)).astype(np.float32)
    router = np.asarray(jp["layers"]["moe"]["router"]["w"][0])
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(x), jnp.asarray(router)), axis=-1)
    jw, ji = jax.lax.top_k(probs, 2)
    jw = jw / jnp.sum(jw, axis=-1, keepdims=True)
    tw, ti = TM.route(torch.from_numpy(x), tp["layers"][0]["moe"]["router"]["w"], 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


# --- expert projections and the MoE block


def _block_input(seed=5, rows=24, scale=30.0):
    """A norm output in int8 units (the prescaled per-tensor input)."""
    return (scale * np.random.default_rng(seed).normal(size=(rows, 64))).astype(np.float32)


@pytest.mark.parametrize("quant", [q for q in QUANT if q != "float"])
def test_expert_projections_match_jax(models, quant):
    """Each expert's w1 (POST_NORM) and w2 (SCALED) on the dense route (JAX's
    per-expert ``linear``) and on the sparse one (JAX's
    ``_batched_expert_linear`` over a bucket): int8 bit-equal, int8
    activations and int32 accumulators included; fp8 and int4 within 1e-5
    relative."""
    from autosmoothquant_tpu.models.common import LinearKind as JK
    from autosmoothquant_tpu.quant import math as jqm
    from autosmoothquant_tpu_torch.kernels.gemm import int8_matmul
    from autosmoothquant_tpu_torch.quant import math as tqm

    cfg, tcfg, jp, tp, qcfg, tq, _ = models(quant)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tmoe = tp["layers"][0]["moe"]
    x = _block_input()
    act = np.abs(_block_input(6, scale=0.5)[:, :1] * np.ones((1, 96), np.float32))
    act = (act * np.random.default_rng(7).normal(size=(24, 96))).astype(np.float32)
    exact = qcfg.is_int8
    buckets = {name: np.asarray(JM._batched_expert_linear(
        jnp.broadcast_to(jnp.asarray(inp), (4,) + inp.shape), jmoe[name], qcfg, gran, kind,
        jnp.float32)) for name, inp, kind, gran in (("w1", x, JK.POST_NORM, qcfg.fc1),
                                                    ("w2", act, JK.SCALED, qcfg.fc2))}
    for e in range(cfg.num_local_experts):
        for name, inp, kind, gran in (("w1", x, JK.POST_NORM, qcfg.fc1),
                                      ("w2", act, JK.SCALED, qcfg.fc2)):
            for sparse in (False, True):
                if sparse:
                    want = buckets[name][e]
                else:
                    want = JM._expert_linear(jnp.asarray(inp), jmoe[name], e, qcfg, gran, kind,
                                             jnp.float32)
                shared = (TM._shared_input(torch.from_numpy(inp), tmoe[name], tq, gran, sparse)
                          if name == "w1" else None)
                got = TM._proj(torch.from_numpy(inp), shared, tmoe[name], e, tq, gran, kind,
                               torch.float32, sparse)
                if exact:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                                  err_msg=f"{name} {e} {sparse}")
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                               atol=1e-5 * float(np.abs(want).max()))
        if quant == "int8":
            # w1's int8 input and int32 accumulator, one expert at a time
            jq_ = jqm.quantize_act_prescaled(jnp.asarray(x))
            tq_ = tqm.quantize_act_prescaled(torch.from_numpy(x))
            np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
            jacc = jnp.dot(jq_, jmoe["w1"]["w"][e], preferred_element_type=jnp.int32)
            tacc = int8_matmul(tq_, tmoe["w1"]["w"][e])
            np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc).astype(np.float32))


@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("quant", list(QUANT))
def test_moe_block_matches_jax(models, quant, route):
    """The whole block (route, experts, combine) on 24 rows, JAX forced to
    the same route."""
    cfg, tcfg, jp, tp, qcfg, tq, _ = models(quant)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    x = _block_input(8) / (30.0 if qcfg is None or not qcfg.is_int8 else 1.0)
    with jrt.override(moe=route, clear_caches=False):
        want, _ = JM._moe_block(jnp.asarray(x), jmoe, cfg, qcfg, False, False, jnp.float32)
    top_w, top_idx = TM.route(torch.from_numpy(x), tp["layers"][0]["moe"]["router"]["w"], 2)
    fn = TM.moe_sparse if route == "sparse" else TM.moe_dense
    got = fn(torch.from_numpy(x), tp["layers"][0]["moe"], tcfg, tq, torch.float32, top_w,
             top_idx)
    assert TM.use_sparse(24, 4, False, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", ["float", "int8", "int8_per_token", "fp8_e4m3_static", "int4"])
def test_dense_and_sparse_routes_give_the_same_bits(models, quant):
    """The port's two routes combine in one order (ascending experts, f32),
    so a token that is not dropped gets the same bits on either (fp8 e4m3
    dynamic is left out: the dense route scales per tensor, the sparse one
    per row, as in JAX)."""
    cfg, tcfg, jp, tp, qcfg, tq, _ = models(quant)
    moe = tp["layers"][1]["moe"]
    x = torch.from_numpy(_block_input(9, rows=40) / (1.0 if tq and tq.is_int8 else 30.0))
    top_w, top_idx = TM.route(x, moe["router"]["w"], 2)
    dense = TM.moe_dense(x, moe, tcfg, tq, torch.float32, top_w, top_idx)
    sparse = TM.moe_sparse(x, moe, tcfg, tq, torch.float32, top_w, top_idx)
    assert torch.equal(dense, sparse)


# --- the model


@pytest.mark.parametrize("quant", list(QUANT))
def test_forward_matches_jax(models, quant, monkeypatch):
    """Prefill of 2 x 12 tokens (T 24: the sparse route) and one decode step
    (T 2: JAX's dense route; the port's routed route in W8A8 and fp8 e4m3
    dynamic, dense in the others), f32 KV cache: the logits of both; the
    float and int8 models also at a prefill of 2 x 6 (T 12: dense). JAX runs
    its own rule ("auto"), which picks these routes too."""
    cfg, tcfg, jp, tp, qcfg, tq, _ = models(quant)
    routed_calls = []
    moe_routed = TM.moe_routed
    monkeypatch.setattr(TM, "moe_routed", lambda x2, *a, **kw: (
        routed_calls.append(x2.shape[0]), moe_routed(x2, *a, **kw))[1])
    routed = quant in ("int8", "int8_mixed", "int8_per_token", "fp8_e4m3")
    assert TM.routed_format(tq, tp["layers"][0]["moe"]) == routed
    rng = np.random.default_rng(32)
    lengths = (12, 6) if quant in ("float", "int8") else (12,)
    for t in lengths:
        ids = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
        assert TM.use_sparse(2 * t, 4, False, False) == (t == 12)
        with jrt.override(moe="auto", clear_caches=False):
            j_pre, j_dec, tok = run_jax_cached(JM, cfg, jp, qcfg, ids, jnp.float32)
        del routed_calls[:]
        t_pre, t_dec = run_port_cached(TM, tcfg, tp, tq, ids, torch.float32, tok)
        # the decode step's two layers, and nothing of the prefill
        assert routed_calls == ([2, 2] if routed else []), (quant, routed_calls)
        np.testing.assert_allclose(t_pre, j_pre, **TOL)
        np.testing.assert_allclose(t_dec, j_dec, **TOL)


def test_hf_logits_match(tmp_path):
    """An HF MixtralForCausalLM (transformers, eager attention) through the
    port's float mapper: the logits of 2 x 16 tokens (tests/test_mixtral.py's
    bar: rtol 5e-4, atol 5e-3)."""
    from transformers import MixtralConfig, MixtralForCausalLM

    from autosmoothquant_tpu_torch.convert.hf import load_hf_params

    torch.manual_seed(0)
    hf = MixtralForCausalLM(MixtralConfig(attn_implementation="eager",
                                          tie_word_embeddings=False, **TINY)).eval().float()
    _, tcfg = _cfgs()
    params = load_hf_params(dict(hf.state_dict()), "mixtral", 2, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(2, 16)))
    with torch.no_grad():
        want = hf(ids).logits.numpy()
        got = TM.logits(params, TM.forward(params, ids, tcfg)[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)


def test_all_experts_calibration_mode(models):
    """calibrate_all_experts routes every token to every expert: finite
    outputs that differ from top-2 routing, and JAX's."""
    cfg, tcfg, jp, tp, *_ = models()
    ids = _batches(1, seed=3)[0]
    h_all, _ = TM.forward(tp, torch.from_numpy(ids).long(), tcfg, calibrate_all_experts=True)
    h_top, _ = TM.forward(tp, torch.from_numpy(ids).long(), tcfg)
    assert torch.isfinite(h_all).all() and not torch.allclose(h_all, h_top)
    want, _, _ = JM.forward_jit(jp, jnp.asarray(ids), cfg, calibrate_all_experts=True)
    np.testing.assert_allclose(h_all.numpy(), np.asarray(want), **TOL)


# --- calibration, smoothing and quantization


def test_calibrate_and_scales_match_jax(models):
    """The all-experts statistics (the float pass) and the routed ones (the
    smoothed pass's) against JAX's within rtol 1e-5, every expert's
    populated; the scales of equal statistics bit-equal."""
    from autosmoothquant_tpu.calibrate.calibrate import calibrate as jcal
    from autosmoothquant_tpu_torch.calibrate.calibrate import calibrate

    cfg, tcfg, jp, tp, _, _, stats = models()
    for kw, want in ((TM.CALIBRATION_FORWARD_KWARGS, stats),
                     (None, jcal(JM, jp, cfg, iter(_batches())))):
        got = calibrate(TM, tp, tcfg, iter(_batches()), extra_forward_kwargs=kw)
        assert tuple(got) == TM.STAT_KEYS
        for k in TM.STAT_KEYS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=0,
                                       err_msg=k)
    assert got["down_in_ch_absmax_per_expert"].shape == (2, 4, 96)
    assert (got["down_in_ch_absmax_per_expert"] > 0).all()
    for fn in ("layer_scales", "fp8_observer_scales", "act_scales_dict"):
        want = {k: np.asarray(v) for k, v in getattr(JM, fn)(stats).items()}
        have = getattr(TM, fn)({k: _t(v) for k, v in stats.items()})
        assert list(have) == list(want), fn
        for k in want:
            np.testing.assert_array_equal(have[k].numpy(), want[k], err_msg=k)


def test_smooth_matches_jax(models):
    """Each side's smooth of JAX's statistics (ln2 over the router and every
    expert's w1 and w3): within a relative 2^-21."""
    cfg, tcfg, jp, tp, _, _, stats = models()
    want = params_from_jax(to_numpy_tree(JM.smooth(jp, stats, 0.5, cfg=cfg)), tcfg,
                           device="cpu")
    got = dict(leaves(TM.smooth(tp, stats, 0.5, cfg=tcfg)))
    for path, a in leaves(want):
        b = got[path]
        assert bool(((a.double() - b.double()).abs() <= 2.0**-21 * a.double().abs()).all()), path


FORMATS = {
    "int8": {"type": "int8"},
    "int8_per_token": QUANT["int8_per_token"],
    "fp8_e4m3": {"type": "fp8_e4m3"},
    "fp8_e4m3_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
    "fp8_e5m2": {"type": "fp8_e5m2"},
    "int4": {"type": "int4", "group_size": 16},
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_same_inputs_bit_equal(models, fmt):
    """JAX's smoothed params and scales through both quantizes: every leaf
    bit-equal (per-expert [E] scales, the float router); fp8 static also
    with observer and output scales and w2 left float by the ignore keys."""
    cfg, tcfg, jp, tp, _, _, stats = models()
    jsm = JM.smooth(jp, stats, 0.5, cfg=cfg)
    tsm = params_from_jax(to_numpy_tree(jsm), tcfg, device="cpu")
    kws = [{}]
    if fmt == "fp8_e4m3_static":
        kws.append(dict(ignore=frozenset({"w2"}), quantize_output=True))
    for kw in kws:
        jkw, tkw = dict(kw), dict(kw)
        if kw:
            jkw["observer_scales"] = JM.fp8_observer_scales(stats)
            tkw["observer_scales"] = TM.fp8_observer_scales({k: _t(v) for k, v in stats.items()})
        want = JM.quantize(jsm, JQ(**FORMATS[fmt]), JM.layer_scales(stats), cfg=cfg, **jkw)
        got = TM.quantize(tsm, TQ(**FORMATS[fmt]),
                          TM.layer_scales({k: _t(v) for k, v in stats.items()}), cfg=tcfg, **tkw)
        assert_bit_equal(params_from_jax(to_numpy_tree(want), tcfg, device="cpu"), got)
        assert got["layers"][0]["moe"]["router"]["w"].dtype == torch.float32


def test_int8_pipeline_router_stays_float_and_artifact_round_trip(models, tmp_path):
    """calibrate_smooth_quantize (int8) on the port (tests/test_mixtral.py):
    the router float, experts int8 [E, N, K] with per-expert dequant scales
    and w2 quant scales [E], KL to the float model < 1e-2; saved as the
    artifact and loaded back through config.json's family: the same params
    and logits."""
    from autosmoothquant_tpu_torch.convert.from_jax import params_to_jax
    from autosmoothquant_tpu_torch.convert.pipeline import (calibrate_smooth_quantize,
                                                            load_quantized, save_quantized)

    cfg, tcfg, jp, tp, _, _, _ = models()
    qcfg = TQ(type="int8")
    qp, art = calibrate_smooth_quantize(TM, tp, tcfg, qcfg, lambda: iter(_batches()))
    moe = qp["layers"][0]["moe"]
    assert moe["router"]["w"].dtype == torch.float32 and moe["w1"]["w"].dtype == torch.int8
    assert moe["w1"]["w"].shape == (4, 96, 64)
    assert moe["w2"]["dequant_scale"].shape == moe["w2"]["quant_scale"].shape == (4,)
    ids = torch.from_numpy(_batches(1, seed=9)[0]).long()
    ref = TM.logits(tp, TM.forward(tp, ids, tcfg)[0])
    got = TM.logits(qp, TM.forward(qp, ids, tcfg, qcfg)[0])
    p, q = torch.softmax(ref, -1), torch.softmax(got, -1)
    assert float((p * (torch.log(p + 1e-12) - torch.log(q + 1e-12))).sum(-1).mean()) < 1e-2
    hf = {"architectures": ["MixtralForCausalLM"], **TINY}
    save_quantized(str(tmp_path), params_to_jax(qp), qcfg, config_dict=hf, artifacts=art)
    qp2, qcfg2, _ = load_quantized(str(tmp_path), device="cpu")
    assert_bit_equal(qp, qp2)
    assert torch.equal(TM.forward(qp, ids, tcfg, qcfg)[0],
                       TM.forward(qp2, ids, TM.config_from_hf(hf), qcfg2)[0])


@pytest.mark.parametrize("fmt", ["int4", "fp8_e4m3_static"])
def test_int4_and_fp8_pipelines(models, fmt):
    """tests/test_int4_families.py and test_fp8_families.py on the port:
    int4 experts packed [E, N, K'/2] with [E, N, G] scales, KL < 5e-2; fp8
    static with output scales, per-expert w_scale [E], the two routes equal
    within 1e-5 as JAX's are."""
    from autosmoothquant_tpu_torch.convert.pipeline import calibrate_smooth_quantize

    cfg, tcfg, jp, tp, _, _, _ = models()
    qcfg = TQ(**FORMATS[fmt])
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 16)).astype(np.int32)
    qp, _ = calibrate_smooth_quantize(TM, tp, tcfg, qcfg, lambda: [ids],
                                      quantize_output=fmt != "int4")
    moe = qp["layers"][0]["moe"]
    tid = torch.from_numpy(ids).long()
    if fmt == "int4":
        assert moe["w1"]["w"].dtype == torch.uint8 and moe["w1"]["w"].shape == (4, 96, 32)
        assert moe["w1"]["w_scales"].shape == (4, 96, 4)
        ref = TM.logits(tp, TM.forward(tp, tid, tcfg)[0])
        got = TM.logits(qp, TM.forward(qp, tid, tcfg, qcfg)[0])
        p, q = torch.softmax(ref, -1), torch.softmax(got, -1)
        assert float((p * (torch.log(p + 1e-12) - torch.log(q + 1e-12))).sum(-1).mean()) < 5e-2
        return
    assert moe["w1"]["w_scale"].shape == moe["w1"]["output_scale"].shape == (4,)
    x = torch.from_numpy(_block_input(10, rows=32) / 30.0)
    top_w, top_idx = TM.route(x, moe["router"]["w"], 2)
    dense = TM.moe_dense(x, moe, tcfg, qcfg, torch.float32, top_w, top_idx)
    sparse = TM.moe_sparse(x, moe, tcfg, qcfg, torch.float32, top_w, top_idx)
    torch.testing.assert_close(sparse, dense, rtol=1e-5, atol=1e-5)


def test_w8a8_router_reads_the_folded_norm(models):
    """Found in the JAX package: its W8A8 Mixtral divides ln2 by
    moe_input_scale (JAX mixtral.py:822-823) and keeps the float router
    (:825), which reads that same ln2 output (:383), so the router's logits
    are scaled by 1 / moe_input_scale and top-2 routing collapses toward
    top-1. The port is held to JAX: the same tiny int8 model through both
    pipelines gives the same top-2 weights, which differ from the float
    model's; the mechanism is ln2 / moe_input_scale before an unchanged
    router."""
    from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize as jcsq
    from autosmoothquant_tpu.models.common import rms_norm as jrms
    from autosmoothquant_tpu_torch.kernels.fused import rms_norm

    cfg, tcfg, jp, tp, _, _, _ = models()
    rows = np.random.default_rng(0).integers(0, 256, size=(1, 8)).astype(np.int32)
    jq, art = jcsq(JM, jp, cfg, JQ(type="int8"), lambda: [rows])
    tq = params_from_jax(to_numpy_tree(jq), tcfg, device="cpu")
    sm = JM.smooth(jp, art["act_stats_fp"], 0.5, cfg=cfg)
    h = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
    eps = cfg.rms_norm_eps

    def jax_top2(params):
        lay = jax.tree.map(lambda a: a[0], params["layers"])
        x = jrms(jnp.asarray(h), lay["ln2"]["w"], eps)
        probs = jax.nn.softmax(jnp.dot(x, lay["moe"]["router"]["w"]), axis=-1)
        w, i = jax.lax.top_k(probs, 2)
        return np.asarray(w / w.sum(-1, keepdims=True)), np.asarray(i)

    jw_q, ji_q = jax_top2(jq)
    jw_f, _ = jax_top2(sm)
    lp = tq["layers"][0]
    tw, ti = TM.route(rms_norm(torch.from_numpy(h), lp["ln2"]["w"], eps), lp["moe"]["router"]["w"],
                      2)
    np.testing.assert_array_equal(ti.numpy(), ji_q)
    np.testing.assert_allclose(tw.numpy(), jw_q, rtol=1e-6, atol=1e-7)
    assert np.abs(jw_q - jw_f).max() > 0.1          # the W8A8 weights are not the float's
    assert jw_q[:, 0].min() > jw_f[:, 0].min()       # and lean toward the first expert
    # the mechanism: the folded ln2 before the unchanged float router
    moe_in = float(art["layer_scales"]["moe_input_scale"][0])
    sm0 = jax.tree.map(lambda a: a[0], sm["layers"])
    np.testing.assert_allclose(lp["ln2"]["w"].numpy(), np.asarray(sm0["ln2"]["w"]) / moe_in,
                               rtol=1e-6)
    np.testing.assert_array_equal(lp["moe"]["router"]["w"].numpy(),
                                  np.asarray(sm0["moe"]["router"]["w"]))


# --- checkpoints


def _hf_state_dict(cfg, seed=0):
    """A random HF Mixtral state dict (numpy, [out, in] weights)."""
    rng = np.random.default_rng(seed)
    D, I, V, E = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_local_experts
    KV = cfg.num_key_value_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.normal(size=(V, D)),
          "model.norm.weight": 1 + 0.1 * rng.normal(size=D),
          "lm_head.weight": rng.normal(size=(V, D))}
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}"
        sd.update({f"{b}.input_layernorm.weight": 1 + 0.1 * rng.normal(size=D),
                   f"{b}.post_attention_layernorm.weight": 1 + 0.1 * rng.normal(size=D),
                   f"{b}.self_attn.q_proj.weight": rng.normal(size=(D, D)),
                   f"{b}.self_attn.k_proj.weight": rng.normal(size=(KV, D)),
                   f"{b}.self_attn.v_proj.weight": rng.normal(size=(KV, D)),
                   f"{b}.self_attn.o_proj.weight": rng.normal(size=(D, D)),
                   f"{b}.block_sparse_moe.gate.weight": rng.normal(size=(E, D))})
        for e in range(E):
            ex = f"{b}.block_sparse_moe.experts.{e}"
            sd.update({f"{ex}.w1.weight": rng.normal(size=(I, D)),
                       f"{ex}.w3.weight": rng.normal(size=(I, D)),
                       f"{ex}.w2.weight": rng.normal(size=(D, I))})
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_hf_mappers_match_jax():
    """The float mapper (experts stacked, the expert count read from the
    checkpoint) and the reference's int8 checkpoint mapper (per-expert int8
    weights and scalars stacked to [E]) against JAX's: the same params, in
    the port's layout."""
    from autosmoothquant_tpu.convert import hf as JH
    from autosmoothquant_tpu_torch.convert import hf as TH

    cfg, tcfg = _cfgs()
    sd = _hf_state_dict(cfg)
    want = params_from_jax(to_numpy_tree(JH.mixtral_params_from_state_dict(sd, 2)), tcfg,
                           device="cpu")
    got = TH.load_hf_params({k: torch.from_numpy(v) for k, v in sd.items()}, "mixtral", 2,
                            device="cpu")
    for (pa, a), (pb, b) in zip(sorted(leaves(want)), sorted(leaves(got))):
        assert pa == pb
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=pa)

    rng = np.random.default_rng(1)
    qsd = {k: v for k, v in sd.items() if "proj" not in k and "experts" not in k}
    shapes = {"self_attn.q_proj": (64, 64), "self_attn.k_proj": (32, 64),
              "self_attn.v_proj": (32, 64), "self_attn.o_proj": (64, 64)}
    shapes.update({f"block_sparse_moe.experts.{e}.{w}": ((64, 96) if w == "w2" else (96, 64))
                   for e in range(4) for w in ("w1", "w3", "w2")})
    for i in range(2):
        for name, (n, k) in shapes.items():
            base = f"model.layers.{i}.{name}"
            qsd[f"{base}.weight"] = rng.integers(-127, 128, (n, k)).astype(np.int8)
            qsd[f"{base}.dequant_scale"] = np.float32(rng.uniform(1e-3, 1e-2))
            if name.endswith(("o_proj", "w2")):
                qsd[f"{base}.quant_scale"] = np.float32(rng.uniform(1e-2, 1e-1))
    qsd = {k: torch.as_tensor(v) for k, v in qsd.items()}
    want = params_from_jax(to_numpy_tree(JH.quantized_mixtral_params_from_state_dict(qsd, 2)),
                           tcfg, device="cpu")
    got = TH._QUANTIZED_LOADERS["mixtral"](qsd, 2, device="cpu")
    for (pa, a), (pb, b) in zip(sorted(leaves(want)), sorted(leaves(got))):
        assert pa == pb and a.dtype == b.dtype, (pa, pb, a.dtype, b.dtype)
        torch.testing.assert_close(b, a.reshape(b.shape), rtol=1e-6, atol=1e-7, msg=pa)
    assert got["layers"][0]["moe"]["w2"]["quant_scale"].shape == (4,)


# --- generation


RAGGED = [[5, 9, 1, 77, 3, 8, 100, 12, 40] * 2, [7, 7, 2] * 3, [200, 1, 2, 3, 4, 5]]


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_engine_greedy_equals_jax(models, quant):
    """Engine.generate on ragged prompts (a 3 x 18 prefill: the sparse route;
    decode at T 3: the dense one): JAX's greedy tokens."""
    from autosmoothquant_tpu.serve import engine as JE
    from autosmoothquant_tpu_torch.serve import engine as TE

    cfg, tcfg, jp, tp, qcfg, tq, _ = models(quant)
    je = JE.Engine(JM, jp, cfg, qcfg, max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    te = TE.Engine(TM, tp, tcfg, tq, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                   compute_dtype=torch.float32, device="cpu")
    got = te.generate(RAGGED, TE.GenerationConfig(max_new_tokens=8))
    assert got == je.generate(RAGGED, JE.GenerationConfig(max_new_tokens=8))


@pytest.mark.parametrize("kv", [torch.float32, torch.int8])
def test_paged_equals_contiguous(models, kv):
    """The float model through the PagedEngine (pages of 16, a registered
    prefix, chunks of 16: the sparse route at each chunk, the dense one at
    decode) gives the ContinuousEngine's tokens and the static engine's
    (tests/test_paged_families.py's Mixtral case)."""
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    cfg, tcfg, jp, tp, *_ = models()
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 256, 20).tolist()
    prompts = [prefix + rng.integers(1, 256, n).tolist() for n in (9, 23)]
    prompts += [rng.integers(1, 256, n).tolist() for n in (5, 33)]
    kw = dict(max_batch=4, max_seq=96, prefill_chunk=16, steps_per_sync=4, kv_dtype=kv,
              compute_dtype=torch.float32, device="cpu")
    outs = []
    for eng in (ContinuousEngine(TM, tp, tcfg, None, **kw),
                PagedEngine(TM, tp, tcfg, None, block_size=16, **kw)):
        eng.register_prefix("sys", prefix)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=10, **({"prefix": "sys"} if i < 2 else {}))
        outs.append(eng.run())
    assert outs[0] == outs[1]
    static = Engine(TM, tp, tcfg, None, max_batch=1, max_seq=96, kv_dtype=kv,
                    compute_dtype=torch.float32, device="cpu")
    for i, p in enumerate(prompts):
        assert static.generate([p], GenerationConfig(max_new_tokens=10))[0] == outs[0][i], i


def test_speculative_greedy_equals_plain(models):
    """n-gram speculation (γ 3): plain greedy's tokens (a verify of 2 x 4
    rows takes the dense route)."""
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    cfg, tcfg, jp, tp, *_ = models()
    eng = Engine(TM, tp, tcfg, None, max_batch=2, max_seq=96, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    prompts = [[3, 4, 5, 6] * 6, [9, 8, 7] * 5]
    plain = eng.generate(prompts, GenerationConfig(max_new_tokens=16))
    spec = eng.generate(prompts, GenerationConfig(max_new_tokens=16, speculative_gamma=3))
    assert spec == plain and eng.last_spec_stats[0] > 0


# --- the smoothquant_model CLI (tests/test_cli.py's Mixtral case)


def test_smoothquant_cli_to_served_artifact(tmp_path, capsys):
    """An HF Mixtral checkpoint written by transformers' save_pretrained
    through the smoothquant_model CLI (all-experts calibration, per-expert
    scales): an artifact that the JAX package's and the port's loaders read
    to the same arrays, and that test_model serves with the static engine's
    greedy tokens over the loaded params."""
    import json

    from transformers import MixtralConfig, MixtralForCausalLM

    from autosmoothquant_tpu.convert.pipeline import load_any_quantized as jload
    from autosmoothquant_tpu_torch.cli import load
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    from test_torch_baichuan import run_cli_and_serve, write_tokenizer_and_data

    torch.manual_seed(0)
    hf = MixtralForCausalLM(MixtralConfig(attn_implementation="eager",
                                          tie_word_embeddings=False, **TINY)).eval().float()
    hf_dir = tmp_path / "hf"
    hf.save_pretrained(hf_dir, safe_serialization=True)
    write_tokenizer_and_data(hf_dir, TINY["vocab_size"])
    art, served = run_cli_and_serve(hf_dir, tmp_path / "out", capsys)
    assert json.loads((art / "config.json").read_text())["model_type"] == "mixtral"
    model, family, pcfg, params, qcfg = load(str(art), "cpu")
    assert model is TM and family == "mixtral" and qcfg.type == "int8"
    assert params["layers"][0]["moe"]["w2"]["quant_scale"].shape == (4,)
    jparams, _, _ = jload(str(art))
    want = dict(leaves(params_from_jax(to_numpy_tree(jparams), pcfg, device="cpu")))
    for path, a in leaves(params):
        assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path
    eng = Engine(TM, params, pcfg, qcfg, max_batch=1, max_seq=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    assert served == eng.generate([[7, 12, 9, 101]], GenerationConfig(max_new_tokens=4))[0]
