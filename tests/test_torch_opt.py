"""The OPT family of the port against the JAX package's, on a tiny config
(hidden 128, 4 heads of 32, ffn 256, 2 layers, vocab 256): the fused
add+LayerNorm+int8 kernel's plain version against the Pallas kernel in
interpret mode, ``opt.forward`` (prefill and one decode step) in every arm,
float OPT with nonzero biases against ``transformers.OPTForCausalLM``, the
loader, the engine and the registry.

Quantized JAX params are drawn with nonzero linear biases and LayerNorm
weights and biases before they are quantized (``test_torch_util.jax_opt``).

Tolerances (max |port - JAX| of logits, whose std is ~0.2-0.3), as in
``test_torch_llama.py``: float 1e-5 (f32 sums in another order); int8 3e-2
(they agree to ~1e-6 until a last-bit difference lands an activation on the
other side of a rounding boundary, which moves it one int8 step); fp8 and
int4 0.1 (one e4m3 step is 1/16-1/8 of the value it rounds). Measured
maxima on this config (CPU): float 5.8e-7; int8 per-tensor fused 2.4e-7,
JAX unfused 2.4e-7, per-token 4.2e-7, int8 KV cache 2.4e-7, post-LN with
project_in/out 1.8e-7 (logit std 0.15); fp8 3.9e-7; int4 4.2e-7: no
rounding flip landed in these inputs, and the tolerances leave room for one.

K6's plain version against the Pallas kernel: ``s`` bit-equal and ``q``
within one step on <= 0.1% of elements (the f32 sums of the mean and the
variance run in another order), with outlier channels at +-50 sigma and a
common offset of +20, where a one-pass variance would cancel.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.kernels import fused as JF
from autosmoothquant_tpu.serve import engine as JE
from autosmoothquant_tpu_torch.convert import pipeline as TP
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.kernels import fused as TF
from autosmoothquant_tpu_torch.models import common as TC
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.models import opt as TO
from autosmoothquant_tpu_torch.models import registry as TR
from autosmoothquant_tpu_torch.quant import math as tmath
from autosmoothquant_tpu_torch.serve import engine as TE

from test_torch_util import (TINY_OPT, jax_opt, one_torch_thread, port_opt_config,  # noqa: F401
                             port_qcfg, run_jax_cached, run_port_cached, to_numpy_tree)

# ---------------------------------------------------------------------------
# K6: fused residual add + LayerNorm + int8 quantize
# ---------------------------------------------------------------------------


def _ln_inputs(t, d, seed):
    """h, x [T, D] with a common offset of +20 and a few outlier channels at
    +-50 sigma; gamma, beta carrying a folded input scale."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)) + 20.0
    out = rng.choice(d, size=4, replace=False)
    h[:, out] += 50.0 * rng.choice([-1.0, 1.0], size=4)
    x = rng.normal(size=(t, d))
    g = rng.random(d) * 40 + 5
    b = rng.normal(size=d) * 5
    return [a.astype(np.float32) for a in (h, x, g, b)]


@pytest.mark.parametrize("t", [1, 8, 256])
@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_add_layernorm_quant_matches_pallas(t, d, dtype):
    h, x, g, b = _ln_inputs(t, d, seed=t * 1000 + d)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jh, jq = JF.fused_add_layernorm_quant(jnp.asarray(h, jdt), jnp.asarray(x, jdt),
                                          jnp.asarray(g), jnp.asarray(b), eps=1e-5,
                                          interpret=True)
    th, tq = TF.fused_add_layernorm_quant(torch.from_numpy(h).to(tdt),
                                          torch.from_numpy(x).to(tdt),
                                          torch.from_numpy(g), torch.from_numpy(b),
                                          eps=1e-5)
    assert th.dtype == tdt and tq.dtype == torch.int8
    np.testing.assert_array_equal(th.float().numpy(), np.asarray(jh.astype(jnp.float32)))
    dq = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3


def test_fused_layernorm_route_gives_the_unfused_chain():
    """The fused add+LayerNorm+quant equals layer_norm followed by
    quantize_act_prescaled, bit for bit, on the int8 it feeds fc1."""
    h, x, g, b = (torch.from_numpy(a) for a in _ln_inputs(40, 256, seed=7))
    s, q = TF.fused_add_layernorm_quant(h, x, g, b, eps=1e-5)
    chain = tmath.quantize_act_prescaled(TC.layer_norm(h + x, g, b, 1e-5))
    torch.testing.assert_close(s, h + x, rtol=0, atol=0)
    torch.testing.assert_close(q, chain, rtol=0, atol=0)


def test_two_pass_variance_survives_a_common_offset():
    """With a large common offset the one-pass E[s^2] - mean^2 cancels in
    f32; the two-pass variance keeps q where the float64 LayerNorm puts it."""
    h, x, g, b = _ln_inputs(16, 512, seed=3)
    h += 3000.0
    _, q = TF.fused_add_layernorm_quant(torch.from_numpy(h), torch.from_numpy(x),
                                        torch.from_numpy(g), torch.from_numpy(b))
    s = (h.astype(np.float32) + x).astype(np.float64)
    c = s - s.mean(-1, keepdims=True)
    y = c / np.sqrt((c * c).mean(-1, keepdims=True) + 1e-5) * g + b
    ref = np.clip(np.round(y), -128, 127)
    assert np.abs(q.numpy() - ref).max() <= 1


def test_fused_add_layernorm_quant_checks_its_inputs():
    h = torch.zeros(4, 64)
    before = TF.fused_add_layernorm_quant.launches
    with pytest.raises(ValueError):
        TF.fused_add_layernorm_quant(h, h, torch.ones(64), torch.zeros(32))
    with pytest.raises(ValueError):
        TF.fused_add_layernorm_quant(h, torch.zeros(4, 32), torch.ones(64),
                                     torch.zeros(64))
    TF.fused_add_layernorm_quant(h, h, torch.ones(64), torch.zeros(64))
    assert TF.fused_add_layernorm_quant.launches == before  # CPU: the plain version


def test_layer_norm_matches_jax():
    from autosmoothquant_tpu.models import common as JC

    h, _, g, b = _ln_inputs(12, 256, seed=5)
    j = JC.layer_norm(jnp.asarray(h), jnp.asarray(g), jnp.asarray(b), 1e-5)
    t = TC.layer_norm(torch.from_numpy(h), torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    # f32 sums in another order, times gamma (up to 45)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# opt.forward against the JAX package
# ---------------------------------------------------------------------------

PER_TOKEN = {"qkv": "per-token", "out": "per-token", "fc1": "per-token",
             "fc2": "per-token"}
# arm: (quant kwargs, JAX KV dtype, tolerance, JAX ASQ_FUSED_BLOCK, config overrides)
ARMS = {
    "float": (None, jnp.float32, 1e-5, "force", {}),
    "int8_per_tensor": ({"type": "int8"}, jnp.float32, 3e-2, "force", {}),
    "int8_per_tensor_jax_unfused": ({"type": "int8"}, jnp.float32, 3e-2, "off", {}),
    "int8_per_token": ({"type": "int8", **PER_TOKEN}, jnp.float32, 3e-2, "force", {}),
    "int8_kv": ({"type": "int8"}, jnp.int8, 3e-2, "force", {}),
    "int8_post_ln_proj": ({"type": "int8"}, jnp.float32, 3e-2, "force",
                          {"do_layer_norm_before": False, "word_embed_proj_dim": 64}),
    "fp8_e4m3": ({"type": "fp8_e4m3"}, jnp.float32, 0.1, "force", {}),
    "int4": ({"type": "int4", "group_size": 64}, jnp.float32, 0.1, "force", {}),
}


def _port(JO, cfg, params, qcfg):
    return port_opt_config(cfg), params_from_jax(to_numpy_tree(params), device="cpu"), \
        port_qcfg(qcfg)


def _kv(kv_dtype):
    return torch.int8 if kv_dtype == jnp.int8 else torch.float32


@pytest.mark.parametrize("arm", list(ARMS))
def test_forward_matches_jax(arm, monkeypatch):
    qkw, kv_dtype, tol, fused_block, over = ARMS[arm]
    monkeypatch.setenv("ASQ_FUSED_BLOCK", fused_block)
    jax.clear_caches()
    JO, cfg, params, qcfg = jax_opt(qkw, seed=1, **over)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JO, cfg, params, qcfg, ids, kv_dtype)
    tcfg, tparams, tq = _port(JO, cfg, params, qcfg)
    t_pre, t_dec = run_port_cached(TO, tcfg, tparams, tq, ids, _kv(kv_dtype), tok)
    np.testing.assert_allclose(t_pre, j_pre, atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


@pytest.mark.parametrize("arm", ["float", "int8_per_tensor"])
def test_ragged_prefill_matches_jax_on_valid_rows(arm, monkeypatch):
    """Left-padded prompts: the port takes banded flash attention with the
    pad lengths as row starts; JAX (on the CPU) its eager masked path.
    Learned positions of pad rows clamp to 0 in both."""
    qkw, kv_dtype, tol, fused_block, _ = ARMS[arm]
    monkeypatch.setenv("ASQ_FUSED_BLOCK", fused_block)
    jax.clear_caches()
    JO, cfg, params, qcfg = jax_opt(qkw, seed=3)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    pads = np.asarray([0, 5, 13], np.int32)
    positions = np.maximum(np.arange(20)[None, :] - pads[:, None], 0).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JO, cfg, params, qcfg, ids, kv_dtype,
                                       pad_starts=jnp.asarray(pads),
                                       positions=jnp.asarray(positions))
    tcfg, tparams, tq = _port(JO, cfg, params, qcfg)
    t_pre, t_dec = run_port_cached(TO, tcfg, tparams, tq, ids, _kv(kv_dtype), tok,
                                   pad_starts=pads, positions=positions)
    valid = np.arange(20)[None, :] >= pads[:, None]
    np.testing.assert_allclose(t_pre[valid], j_pre[valid], atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


@pytest.mark.parametrize("over", [{}, {"do_layer_norm_before": False,
                                       "word_embed_proj_dim": 64}],
                         ids=["pre_ln", "post_ln_proj"])
def test_cacheless_forward_matches_jax(over, monkeypatch):
    monkeypatch.setenv("ASQ_FUSED_BLOCK", "force")
    jax.clear_caches()
    JO, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=5, **over)
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    h, _, _ = JO.forward_jit(params, jnp.asarray(ids), cfg, qcfg)
    j = np.asarray(JO.logits(params, h))
    tcfg, tparams, tq = _port(JO, cfg, params, qcfg)
    th, cache = TO.forward(tparams, torch.from_numpy(ids).long(), tcfg, tq)
    assert cache is None
    np.testing.assert_allclose(TO.logits(tparams, th).numpy(), j, atol=3e-2, rtol=0)


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_head_dim_80_matches_jax(ragged, monkeypatch):
    """An OPT-2.7B-shaped head (hidden 160 over 2 heads: D = 80, which K3
    runs zero-padded to 128 on the card) in W8A8, prefill and one decode
    step against the JAX OPT, at the int8 tolerance."""
    monkeypatch.setenv("ASQ_FUSED_BLOCK", "force")
    jax.clear_caches()
    JO, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=12, hidden_size=160,
                                    word_embed_proj_dim=160, num_attention_heads=2)
    assert cfg.hidden_size // cfg.num_attention_heads == 80
    ids = np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    kw = {}
    valid = np.ones((3, 20), bool)
    if ragged:
        pads = np.asarray([0, 4, 11], np.int32)
        kw = dict(pad_starts=pads,
                  positions=np.maximum(np.arange(20)[None, :] - pads[:, None], 0).astype(np.int32))
        valid = np.arange(20)[None, :] >= pads[:, None]
    j_pre, j_dec, tok = run_jax_cached(JO, cfg, params, qcfg, ids, jnp.float32,
                                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tcfg, tparams, tq = _port(JO, cfg, params, qcfg)
    t_pre, t_dec = run_port_cached(TO, tcfg, tparams, tq, ids, torch.float32, tok, **kw)
    np.testing.assert_allclose(t_pre[valid], j_pre[valid], atol=3e-2, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=3e-2, rtol=0)


def test_fused_and_unfused_routes_give_the_same_logits(monkeypatch):
    """The pre-LN int8 block through K6 (plain version here) with ReLU in
    fc1's epilogue equals the unfused chain (layer_norm, a POST_NORM fc1,
    then ReLU) bit for bit."""
    JO, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=8)
    tcfg, tparams, tq = _port(JO, cfg, params, qcfg)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12)))
    fused, _ = TO.forward(tparams, ids, tcfg, tq)
    monkeypatch.setattr(TO, "fused_block_enabled", lambda *a, **k: False)
    unfused, _ = TO.forward(tparams, ids, tcfg, tq)
    torch.testing.assert_close(fused, unfused, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# float OPT with nonzero biases against transformers
# ---------------------------------------------------------------------------


def _hf_opt(**over):
    from transformers import OPTConfig, OPTForCausalLM

    kw = {**TINY_OPT, **over}
    torch.manual_seed(0)
    hf = OPTForCausalLM(OPTConfig(attn_implementation="eager", **kw)).eval().float()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "layer_norm" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.2)
    return hf, kw


@pytest.mark.parametrize("over", [{}, {"do_layer_norm_before": False,
                                       "word_embed_proj_dim": 64}],
                         ids=["pre_ln", "post_ln_proj"])
def test_float_opt_with_biases_matches_transformers(over):
    """The port applies every linear bias and LayerNorm beta, as HF's
    OPTForCausalLM does (the JAX float path reads projection biases under
    "bias" while its float OPT params name them "b": ROADMAP Queue 3).
    Measured max |port - HF| 3.3e-7 (pre-LN, logit std 0.21) and 4.2e-8
    (post-LN, std 0.03); the JAX float path misses HF by 1.04 and 0.16 on
    the same inputs."""
    from autosmoothquant_tpu.convert.hf import opt_params_from_state_dict
    from autosmoothquant_tpu.models import opt as JO

    hf, kw = _hf_opt(**over)
    jcfg = JO.OPTConfig(**kw)
    jparams = opt_params_from_state_dict(dict(hf.state_dict()), jcfg.num_hidden_layers)
    params = params_from_jax(to_numpy_tree(jparams), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    with torch.no_grad():
        ref = hf(ids).logits
    h, _ = TO.forward(params, ids, port_opt_config(jcfg))
    np.testing.assert_allclose(TO.logits(params, h).numpy(), ref.numpy(),
                               atol=1e-4, rtol=0)
    # the biases matter here: dropping the linear biases moves the logits
    dropped = {**params, "layers": [
        {**lp, **{grp: {k: {"w": v["w"]} for k, v in lp[grp].items()}
                  for grp in ("attn", "mlp")}} for lp in params["layers"]]}
    h0, _ = TO.forward(dropped, ids, port_opt_config(jcfg))
    assert float((TO.logits(dropped, h0) - ref).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# loader, registry and engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def opt_artifact(tmp_path_factory):
    """A JAX-saved W8A8 OPT artifact (config.json names OPTForCausalLM)."""
    from autosmoothquant_tpu.convert import pipeline as JP

    JO, cfg, qp, qcfg = jax_opt({"type": "int8"}, seed=2)
    path = str(tmp_path_factory.mktemp("asq_opt") / "ckpt")
    config = {**TINY_OPT, "architectures": ["OPTForCausalLM"], "model_type": "opt",
              "do_layer_norm_before": True}
    JP.save_quantized(path, qp, qcfg, config_dict=config)
    return path, cfg


def test_load_quantized_opt_is_byte_equal_with_layernorm_biases(opt_artifact, monkeypatch):
    """Every leaf of the OPT artifact arrives byte-equal, the LayerNorm
    biases (which carry the folded input scale) and the learned positions
    included, and the registry builds an OPTConfig for it."""
    from autosmoothquant_tpu.convert import pipeline as JP

    from test_torch_loader import _bytes, _walk_equal

    path, cfg = opt_artifact
    seen = {}
    real = TP.params_from_jax

    def spy(tree, c, **kw):
        seen["cfg"] = c
        return real(tree, c, **kw)

    monkeypatch.setattr(TP, "params_from_jax", spy)
    params, qcfg, config = TP.load_quantized(path, device="cpu")
    assert isinstance(seen["cfg"], TO.OPTConfig)
    assert seen["cfg"] == port_opt_config(cfg)
    jparams, jqcfg, jconfig = JP.load_quantized(path)
    assert qcfg.to_dict() == jqcfg.to_dict() and config == jconfig
    _walk_equal(params, params_from_jax(to_numpy_tree(jparams), device="cpu"),
                cfg.num_hidden_layers)
    stacked = to_numpy_tree(jparams)["layers"]
    for i, lp in enumerate(params["layers"]):
        for ln in ("ln1", "ln2"):
            assert set(lp[ln]) == {"w", "b"} and lp[ln]["b"].dtype == torch.float32
            assert _bytes(lp[ln]["b"]) == _bytes(stacked[ln]["b"][i].astype(np.float32))
        assert _bytes(lp["mlp"]["fc2"]["bias"]) == _bytes(stacked["mlp"]["fc2"]["bias"][i])
    assert set(params["final_norm"]) == {"w", "b"}
    assert _bytes(params["embed_pos"]["w"]) == _bytes(to_numpy_tree(jparams)["embed_pos"]["w"])


def test_load_quantized_refuses_an_unported_family(opt_artifact, tmp_path):
    """The family comes from the registry, not a Llama config read for
    every artifact: an artifact whose config names an architecture no
    package has raises, listing the supported ones (Mixtral among them)."""
    import shutil

    path = str(tmp_path / "falcon")
    shutil.copytree(opt_artifact[0], path)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**TINY_OPT, "architectures": ["FalconForCausalLM"]}, f)
    with pytest.raises(ValueError, match="supported: .*MixtralForCausalLM"):
        TP.load_quantized(path, device="cpu")


def test_params_from_jax_carries_layernorm_biases_and_renames_float_biases():
    """Float OPT params: LayerNorm "b" arrives as f32 beside "w", a float
    projection's "b" becomes "bias", and a config without
    tie_word_embeddings (OPTConfig) is accepted."""
    JO, cfg, params, _ = jax_opt(None, seed=4)
    tree = to_numpy_tree(params)
    tree["layers"]["attn"]["q"]["b"] = np.full_like(tree["layers"]["attn"]["q"]["b"], 0.5)
    del tree["lm_head"]
    out = params_from_jax(tree, port_opt_config(cfg), device="cpu")
    assert "lm_head" not in out
    lp = out["layers"][1]
    assert set(lp["ln1"]) == {"w", "b"} and lp["ln1"]["b"].dtype == torch.float32
    assert set(lp["attn"]["q"]) == {"w", "bias"}
    torch.testing.assert_close(lp["attn"]["q"]["bias"], torch.full((128,), 0.5))
    assert set(out["final_norm"]) == {"w", "b"}


@pytest.mark.parametrize("arch,module", [
    ("OPTForCausalLM", TO), ("Int8OPTForCausalLM", TO), ("LlamaForCausalLM", TL),
    ("QuantizedLlamaForCausalLM", TL), ("Qwen2ForCausalLM", TL),
    ("MistralForCausalLM", TL), ("LLaMAForCausalLM", TL)])
def test_registry_picks_the_family(arch, module):
    assert TR.get_model_family({"architectures": [arch]}) is module


def test_registry_falls_back_to_model_type_and_raises_on_the_rest():
    from autosmoothquant_tpu_torch.models import baichuan as TB
    from autosmoothquant_tpu_torch.models import gemma as TG
    from autosmoothquant_tpu_torch.models import mixtral as TX

    assert TR.get_model_family({"model_type": "opt"}) is TO
    assert TR.get_model_family({"model_type": "llama"}) is TL
    assert TR.get_model_family({"architectures": ["BaichuanForCausalLM"]}) is TB
    assert TR.get_model_family({"architectures": ["GemmaForCausalLM"]}) is TG
    assert TR.get_model_family({"architectures": ["MixtralForCausalLM"]}) is TX
    assert TR.get_model_family({"model_type": "mixtral"}) is TX
    for config in ({"architectures": ["FalconForCausalLM"]}, {"model_type": "falcon"}):
        with pytest.raises(ValueError, match="supported: .*MixtralForCausalLM"):
            TR.get_model_family(config)


RAGGED = [[5, 9, 1, 77, 3, 8, 100, 12, 40], [7, 7, 2], [200, 1, 2, 3, 4, 5]]
EQUAL = [[11, 22, 33, 44, 55, 66], [6, 5, 4, 3, 2, 1]]


@pytest.fixture(scope="module")
def opt_engines():
    JO, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=11)
    je = JE.Engine(JO, params, cfg, qcfg, max_batch=4, max_seq=64,
                   kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    te = TE.Engine(TO, params_from_jax(to_numpy_tree(params), device="cpu"),
                   port_opt_config(cfg), port_qcfg(qcfg), max_batch=4, max_seq=64,
                   kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")
    return je, te


@pytest.mark.parametrize("prompts", [RAGGED, EQUAL], ids=["ragged", "equal"])
def test_engine_greedy_tokens_equal_jax(opt_engines, prompts):
    je, te = opt_engines
    assert (te.generate(prompts, TE.GenerationConfig(max_new_tokens=10))
            == je.generate(prompts, JE.GenerationConfig(max_new_tokens=10)))


def test_engine_serves_opt_unfused(opt_engines):
    """OPT has no fuse_decode_projections: the engine serves it as it is
    (before the repair it raised AttributeError), 6 GEMMs a layer."""
    _, te = opt_engines
    assert not hasattr(TO, "fuse_decode_projections")
    for lp in te.params["layers"]:
        assert set(lp["attn"]) == {"q", "k", "v", "o"} and set(lp["mlp"]) == {"fc1", "fc2"}


def test_config_from_hf_matches_jax():
    from autosmoothquant_tpu.models import opt as JO

    hf = {**TINY_OPT, "do_layer_norm_before": False, "word_embed_proj_dim": 64,
          "enable_bias": True}
    assert dataclasses.asdict(TO.config_from_hf(hf)) == dataclasses.asdict(
        JO.config_from_hf(hf))
    assert TO.POS_OFFSET == JO.POS_OFFSET == 2
