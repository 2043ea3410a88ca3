"""The port's quantize path (``quant/smooth.py``, ``quant/ignore.py``,
``quant/fake_quant.py``, ``calibrate/calibrate.py`` and each family's
``forward(capture_stats=True)``, ``smooth``, ``layer_scales``,
``fp8_observer_scales`` and ``quantize``) against the JAX package's, on the
CPU, on tiny models: Llama (2 layers, hidden 64, GQA 4/2) and OPT pre-LN and
post-LN (hidden 64; the post-LN one with project_in/out), float weights from
JAX's ``init_params`` with norm weights and LayerNorm biases redrawn.

Tolerances, and where bits must be equal:
  - calibrate: every STAT_KEYS leaf within rtol 1e-5 of JAX's (f32 sums in
    another order; measured <= 7e-7).
  - layer_scales, fp8_observer_scales: bit-equal on the same statistics.
  - quantize on the same smoothed params: bit-equal int8 / fp8 / int4
    weights and f32 scales in every format (both sides round the same
    exactly rounded arithmetic).
  - smooth on the same statistics: JAX smooths eagerly, where XLA's
    ``x ** 0.5`` is libm's ``powf``; the port takes ``torch.sqrt`` at alpha
    0.5 (exactly rounded on the CPU and the card alike). ``s`` agrees within
    2 ulp (at 0.5 and 0.8) and the int8 weights quantized from the two
    smoothed models within one step, on at most the shares SMOOTH_SHARE
    states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_util import to_numpy_tree

LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
OPT_PRE = dict(vocab_size=256, hidden_size=64, word_embed_proj_dim=64, ffn_dim=128,
               num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128)
OPT_POST = dict(OPT_PRE, word_embed_proj_dim=32, do_layer_norm_before=False)
FAMILIES = ("llama", "opt_pre", "opt_post")
# the formats quantize is held bit-equal in (QuantConfig kwargs)
FORMATS = {
    "int8": {"type": "int8"},
    "int8_per_token": {"type": "int8", "qkv": "per-token", "out": "per-token",
                       "fc1": "per-token", "fc2": "per-token"},
    "int8_mixed": {"type": "int8", "qkv": "per-token", "fc2": "per-token"},
    "fp8_e4m3": {"type": "fp8_e4m3"},
    "fp8_e4m3_per_token": {"type": "fp8_e4m3", "qkv": "per-token", "out": "per-token",
                           "fc1": "per-token", "fc2": "per-token"},
    "fp8_e4m3_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
    "fp8_e5m2": {"type": "fp8_e5m2"},
    "int4": {"type": "int4", "group_size": 32},
}
# share of int8 weights one step apart when each side smooths the same
# statistics (JAX: powf, the port: sqrt at 0.5; each its own pow at 0.8),
# the rest equal. Measured 0 of 73,728 (Llama) and 0 of 65,536 (OPT pre-LN)
# at both alphas: an ulp of s seldom moves a weight across a rounding tie
SMOOTH_SHARE = {0.5: 1e-3, 0.8: 1e-3}


def _families():
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.models import opt as JO
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import opt as TO

    return {"llama": (JL, TL, JL.LlamaConfig(**LLAMA)),
            "opt_pre": (JO, TO, JO.OPTConfig(**OPT_PRE)),
            "opt_post": (JO, TO, JO.OPTConfig(**OPT_POST))}


def _port_cfg(TM, cfg):
    cls = TM.LlamaConfig if hasattr(TM, "LlamaConfig") else TM.OPTConfig
    return cls(**dataclasses.asdict(cfg))


def draw_float(JM, cfg, seed=0):
    """JAX float params with norm weights N(1, 0.2) and LayerNorm biases
    N(0, 0.2); OPT projection biases stay zero (the JAX float OPT reads no
    "b", the port applies it) and the first q channels of every layer's
    input are scaled up 8x in ln1 (an outlier channel for smoothing to
    move)."""
    rng = np.random.default_rng(seed)
    params = JM.init_params(cfg, jax.random.PRNGKey(seed))
    lay = dict(params["layers"])
    for ln in ("ln1", "ln2"):
        w = 1 + 0.2 * rng.normal(size=lay[ln]["w"].shape)
        if ln == "ln1":
            w[:, :4] *= 8
        lay[ln] = {**lay[ln], "w": jnp.asarray(w, jnp.float32)}
        if "b" in lay[ln]:
            lay[ln]["b"] = jnp.asarray(0.2 * rng.normal(size=lay[ln]["b"].shape), jnp.float32)
    return {**params, "layers": lay}


def batches(vocab, n=2, shape=(2, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=shape).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, JAX module, port module, JAX cfg, port cfg, JAX params, port
    params, JAX statistics of the float model)."""
    from autosmoothquant_tpu.calibrate.calibrate import calibrate as jcal

    JM, TM, cfg = _families()[request.param]
    jp = draw_float(JM, cfg)
    tcfg = _port_cfg(TM, cfg)
    tp = params_from_jax(to_numpy_tree(jp), tcfg, device="cpu")
    stats = jcal(JM, jp, cfg, iter(batches(cfg.vocab_size)))
    return request.param, JM, TM, cfg, tcfg, jp, tp, stats


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def leaves(node, path=""):
    if isinstance(node, dict):
        return [x for k, v in node.items() for x in leaves(v, f"{path}/{k}")]
    if isinstance(node, list):
        return [x for i, v in enumerate(node) for x in leaves(v, f"{path}/{i}")]
    return [(path, node)]


def bits(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


def assert_bit_equal(want, got):
    a, b = dict(leaves(want)), dict(leaves(got))
    assert set(a) == set(b), set(a) ^ set(b)
    unequal = [p for p in a if a[p].dtype != b[p].dtype or a[p].shape != b[p].shape
               or not torch.equal(bits(a[p]), bits(b[p]))]
    assert not unequal, unequal[:8]


# --- smooth, ignore patterns, fake quant (tests/test_smooth.py, test_fake_quant.py)


def test_smooth_scale_formula():
    """s = clamp(act^a / clamp(rowmax|W|, 1e-5)^(1-a), 1e-5): at alpha 0.5
    the exactly rounded square roots (numpy's), at 0.8 within 2 ulp of a
    float64 evaluation."""
    from autosmoothquant_tpu_torch.quant.smooth import compute_smooth_scale

    rng = np.random.default_rng(0)
    act = np.abs(rng.normal(size=16)).astype(np.float32) + 0.1
    w1, w2 = (rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2))
    wmax = np.maximum(np.maximum(np.abs(w1).max(1), np.abs(w2).max(1)), np.float32(1e-5))
    s = compute_smooth_scale(torch.from_numpy(act), [torch.from_numpy(w1),
                                                     torch.from_numpy(w2)], 0.5).numpy()
    np.testing.assert_array_equal(s, np.maximum(np.sqrt(act) / np.sqrt(wmax), np.float32(1e-5)))
    s8 = compute_smooth_scale(torch.from_numpy(act), [torch.from_numpy(w1)], 0.8).numpy()
    ref = act.astype(np.float64) ** 0.8 / np.maximum(np.abs(w1).max(1), 1e-5) ** 0.2
    assert np.all(np.abs(s8 - ref) <= 2 * np.spacing(s8))


@pytest.mark.parametrize("with_bias", [False, True])
def test_smooth_preserves_function(with_bias):
    """(x * g / s + b / s) @ (s W) == (x * g + b) @ W (RMSNorm, and
    LayerNorm with its bias)."""
    from autosmoothquant_tpu_torch.quant.smooth import smooth_norm_fcs

    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=32).astype(np.float32)) if with_bias else None
    w = torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32))
    act = torch.from_numpy(np.abs(rng.normal(size=32)).astype(np.float32) + 0.5)
    new_g, (new_w,), new_b = smooth_norm_fcs(g, [w], act, norm_bias=b)
    x = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    before = (x * g + (0 if b is None else b)) @ w
    after = (x * new_g + (0 if b is None else new_b)) @ new_w
    torch.testing.assert_close(after, before, rtol=2e-4, atol=2e-4)


def test_smooth_params_tree_leaves_input_alone():
    from autosmoothquant_tpu_torch.quant.smooth import SmoothGroup, smooth_params

    rng = np.random.default_rng(11)
    params = {"layers": [{"ln": {"w": torch.ones(8)},
                          "q": {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))}}]}
    scales = {"q": np.abs(rng.normal(size=8)).astype(np.float32) + 0.3}
    out = smooth_params(params, scales, [SmoothGroup(("layers", 0, "ln", "w"),
                                                     (("layers", 0, "q", "w"),), "q")])
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    torch.testing.assert_close(x * out["layers"][0]["ln"]["w"] @ out["layers"][0]["q"]["w"],
                               x @ params["layers"][0]["q"]["w"], rtol=2e-4, atol=2e-4)
    assert torch.equal(params["layers"][0]["ln"]["w"], torch.ones(8))


def test_ignore_patterns_match_jax():
    from autosmoothquant_tpu.quant.ignore import match_ignore_patterns as jmatch
    from autosmoothquant_tpu_torch.quant.ignore import DEFAULT_IGNORE, match_ignore_patterns

    names = ["model.layers.0.mlp.gate_proj", "lm_head", "model.lm_head",
             "model.layers.1.self_attn.q_proj"]
    for pats in (["re:.*lm_head"], ["lm_head"], ["re:.*mlp.*", "lm_head"], list(DEFAULT_IGNORE)):
        assert match_ignore_patterns(names, pats) == jmatch(names, pats)
    assert match_ignore_patterns(names, ["re:.*mlp.*", "lm_head"]) == [
        "model.layers.0.mlp.gate_proj", "lm_head"]


@pytest.mark.parametrize("mode", ["per_channel", "per_tensor"])
def test_fake_quantize_weight_matches_jax(mode):
    """Bit-equal to JAX's round trip; within half a step of the weight; per
    channel tighter than per tensor on anisotropic columns."""
    from autosmoothquant_tpu.quant.fake_quant import fake_quantize_weight as jfq
    from autosmoothquant_tpu_torch.quant.fake_quant import fake_quantize_weight

    w = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    w *= np.logspace(-2, 1, 32)[None, :].astype(np.float32)
    got = fake_quantize_weight(torch.from_numpy(w), mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfq(jnp.asarray(w), mode)))
    assert np.abs(got - w).max() <= np.abs(w).max() / 127 / 2 + 1e-6
    other = "per_tensor" if mode == "per_channel" else "per_channel"
    err_other = np.abs(fake_quantize_weight(torch.from_numpy(w), other).numpy() - w).max()
    assert (np.abs(got - w).max() < err_other) == (mode == "per_channel")


@pytest.mark.parametrize("fn", ["act_per_token", "act_per_tensor", "fp8_per_tensor",
                                "fp8_per_token"])
def test_fake_quantize_activations_match_jax(fn):
    from autosmoothquant_tpu.quant import math as jmath
    from autosmoothquant_tpu_torch.quant import math as tmath

    x = np.random.default_rng(2).normal(size=(8, 32)).astype(np.float32)
    got = getattr(tmath, f"fake_quantize_{fn}")(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jmath, f"fake_quantize_{fn}")(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_fake_quantize_params_matches_jax(family):
    """Every projection weight round-trips as JAX's does; the float model
    stays close. (JAX also round-trips its stacked [L, D] norm weights, a
    2-D leaf named "w"; the port's norms are vectors and stay.)"""
    from autosmoothquant_tpu.quant.fake_quant import fake_quantize_params as jfq
    from autosmoothquant_tpu_torch.quant.fake_quant import (fake_quantize_act,
                                                           fake_quantize_params)

    name, JM, TM, cfg, tcfg, jp, tp, _ = family
    got = fake_quantize_params(tp)
    want = params_from_jax(to_numpy_tree(jfq(jp)), tcfg, device="cpu")
    for i, lp in enumerate(got["layers"]):
        for grp in ("attn", "mlp"):
            for k, p in lp[grp].items():
                assert torch.equal(p["w"], want["layers"][i][grp][k]["w"]), (i, k)
                assert not torch.equal(p["w"], tp["layers"][i][grp][k]["w"])
        assert torch.equal(lp["ln1"]["w"], tp["layers"][i]["ln1"]["w"])
    assert torch.equal(got["embed"]["w"], tp["embed"]["w"])
    assert torch.equal(got["lm_head"]["w"], tp["lm_head"]["w"])
    if name == "llama":  # the model still runs close (JAX's own check)
        ids = torch.from_numpy(batches(cfg.vocab_size, 1)[0]).long()
        a, b = TM.forward(tp, ids, tcfg)[0], TM.forward(got, ids, tcfg)[0]
        assert float((a - b).abs().max() / a.abs().max()) < 0.1
    x = torch.randn(4, 16)
    assert fake_quantize_act(x, "per_tensor").shape == x.shape


# --- calibration statistics


def test_calibrate_matches_jax(family):
    """The port's calibrate (capture forward, batch max, one host copy) on
    JAX's params and batches: every leaf within rtol 1e-5, shapes and keys
    as JAX's."""
    from autosmoothquant_tpu_torch.calibrate.calibrate import calibrate

    name, JM, TM, cfg, tcfg, jp, tp, want = family
    got = calibrate(TM, tp, tcfg, iter(batches(cfg.vocab_size)))
    assert tuple(got) == TM.STAT_KEYS == JM.STAT_KEYS
    for k in TM.STAT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].device.type == "cpu", k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=0, err_msg=k)


def test_capture_forward_returns_the_plain_hidden(family):
    """capture_stats adds statistics and changes nothing else: the hidden
    states equal the plain forward's, and it takes the unfused routes on
    int8 params (its qkv statistic is the norm's output, in int8 units)."""
    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    ids = torch.from_numpy(batches(cfg.vocab_size, 1)[0]).long()
    h, _ = TM.forward(tp, ids, tcfg)
    h2, cache, st = TM.forward(tp, ids, tcfg, capture_stats=True)
    assert torch.equal(h, h2) and cache is None
    assert all(st[k].shape[0] == cfg.num_hidden_layers for k in TM.STAT_KEYS)
    qcfg = TQ(type="int8")
    qp = TM.quantize(TM.smooth(tp, stats, 0.5, cfg=tcfg), qcfg, TM.layer_scales(_t(stats)),
                     cfg=tcfg)
    _, _, st_q = TM.forward(qp, ids, tcfg, qcfg, capture_stats=True)
    if name != "opt_post":  # ln1 holds the folded 1 / input scale: |x| <= ~127
        assert float(st_q["qkv_in_ch_absmax"].max()) <= 128


@pytest.mark.parametrize("fn", ["layer_scales", "fp8_observer_scales", "act_scales_dict"])
def test_scales_bit_equal(family, fn):
    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    want = {k: np.asarray(v) for k, v in getattr(JM, fn)(stats).items()}
    got = getattr(TM, fn)(_t(stats))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# --- smooth and quantize


def _smoothed_pair(family, alpha):
    """(JAX smoothed params in the port's layout, the port's smoothed params)
    of the same statistics."""
    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    want = params_from_jax(to_numpy_tree(JM.smooth(jp, stats, alpha, cfg=cfg)), tcfg,
                           device="cpu")
    return want, TM.smooth(tp, stats, alpha, cfg=tcfg)


def _groups(name, lp):
    """(statistic, norm, [fc weights]) of a layer's smoothing groups."""
    attn, mlp = lp["attn"], lp["mlp"]
    qkv = [attn[n]["w"] for n in ("q", "k", "v")]
    if name == "llama":
        return [("qkv_in_ch_absmax", qkv), ("gate_in_ch_absmax", [mlp["gate"]["w"],
                                                                  mlp["up"]["w"]])]
    return [("qkv_in_ch_absmax", qkv), ("fc1_in_ch_absmax", [mlp["fc1"]["w"]])]


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_smooth_same_stats_within_two_ulp(family, alpha):
    """Each side's smooth of JAX's statistics: ``s`` (JAX's
    compute_smooth_scale run eagerly, as its smooth runs) within 2 ulp of
    the port's for every group; the smoothed weights and norms within a
    relative 2^-21 (2 ulp of s carried through one rounded product); the
    int8 weights quantized from the two within one step on at most
    SMOOTH_SHARE of their entries, the rest equal. A post-LN OPT is
    returned as it is, on both sides."""
    from autosmoothquant_tpu.quant.smooth import compute_smooth_scale as jscale
    from autosmoothquant_tpu_torch.quant.smooth import compute_smooth_scale

    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    for i, lp in enumerate(tp["layers"]):
        for key, fcs in _groups(name, lp):
            want = np.asarray(jscale(jnp.asarray(stats[key][i]),
                                     [jnp.asarray(w.numpy()) for w in fcs], alpha))
            got = compute_smooth_scale(torch.from_numpy(np.array(stats[key][i])), fcs,
                                       alpha).numpy()
            assert np.all(np.abs(got.astype(np.float64) - want) <= 2 * np.spacing(want)), key
    want, got = _smoothed_pair(family, alpha)
    a_all, b_all = dict(leaves(want)), dict(leaves(got))
    assert set(a_all) == set(b_all)
    for pa, a in a_all.items():
        b = b_all[pa]
        assert a.dtype == b.dtype
        assert bool(((a.double() - b.double()).abs() <= 2.0**-21 * a.double().abs()).all()), pa
    if name == "opt_post":
        assert_bit_equal(tp, got)
        return
    scales = TM.layer_scales(_t(stats))
    qa = TM.quantize(want, TQ(type="int8"), scales, cfg=tcfg)
    qb = TM.quantize(got, TQ(type="int8"), scales, cfg=tcfg)
    steps = total = 0
    qb_all = dict(leaves(qb))
    for pa, a in leaves(qa):
        b = qb_all[pa]
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1, pa
            steps, total = steps + int((d > 0).sum()), total + d.numel()
    assert steps / total <= SMOOTH_SHARE[alpha], (steps, total)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_same_inputs_bit_equal(family, fmt):
    """JAX's smoothed params and JAX's scales through both sides'
    quantize: every leaf bit-equal ([out, in] weights, f32 scales, f32
    biases; OPT's biases drawn nonzero here)."""
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    jsm = JM.smooth(jp, stats, 0.5, cfg=cfg)
    if name != "llama":
        rng = np.random.default_rng(5)
        jsm = {**jsm, "layers": {**jsm["layers"], **{
            grp: {k: {**p, "b": jnp.asarray(0.1 * rng.normal(size=p["b"].shape), jnp.float32)}
                  for k, p in jsm["layers"][grp].items()} for grp in ("attn", "mlp")}}}
    tsm = params_from_jax(to_numpy_tree(jsm), tcfg, device="cpu")
    want = JM.quantize(jsm, JQ(**FORMATS[fmt]), JM.layer_scales(stats), cfg=cfg)
    got = TM.quantize(tsm, TQ(**FORMATS[fmt]), TM.layer_scales(_t(stats)), cfg=tcfg)
    assert_bit_equal(params_from_jax(to_numpy_tree(want), tcfg, device="cpu"), got)


@pytest.mark.parametrize("ignore,quantize_output",
                         [((), False), ((), True), (("q", "o"), True)])
def test_quantize_fp8_static_observer_bit_equal(family, ignore, quantize_output):
    """fp8 e4m3 static with observer scales: input (and output) scales on
    every projection the ignore keys leave, those left float; bit-equal."""
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    jsm = JM.smooth(jp, stats, 0.5, cfg=cfg)
    tsm = params_from_jax(to_numpy_tree(jsm), tcfg, device="cpu")
    kw = {"type": "fp8_e4m3", "activation_scheme": "static"}
    want = JM.quantize(jsm, JQ(**kw), JM.layer_scales(stats), cfg=cfg, ignore=frozenset(ignore),
                       quantize_output=quantize_output,
                       observer_scales=JM.fp8_observer_scales(stats))
    got = TM.quantize(tsm, TQ(**kw), TM.layer_scales(_t(stats)), cfg=tcfg,
                      ignore=frozenset(ignore), quantize_output=quantize_output,
                      observer_scales=TM.fp8_observer_scales(_t(stats)))
    assert_bit_equal(params_from_jax(to_numpy_tree(want), tcfg, device="cpu"), got)
    q = got["layers"][0]["attn"]["q"]
    assert (q["w"].dtype == torch.float32) == ("q" in ignore)
    assert ("output_scale" in got["layers"][0]["attn"]["k"]) == quantize_output


def test_quantize_refuses_missing_scales(family):
    name, JM, TM, cfg, tcfg, jp, tp, stats = family
    with pytest.raises(ValueError, match="layer_scales"):
        TM.quantize(tp, TQ(type="int8"), None, cfg=tcfg)
    with pytest.raises(ValueError, match="observer"):
        TM.quantize(tp, TQ(type="fp8_e4m3", activation_scheme="static"), None, cfg=tcfg)
