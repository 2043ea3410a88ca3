"""``llama.forward`` of the port against the JAX package's, prefill and
decode, on a tiny config (head_dim 64), in arms: float f32, int8 per-tensor
(JAX on its fused add+norm+quant block, ASQ_FUSED_BLOCK=force), int8
per-token, int8 with an int8 KV cache, fp8 e4m3 dynamic per-tensor and
per-token, fp8 e4m3 static, fp8 e5m2, and int4 (W4A8 at M = 48; one int4
arm prefills 2 x 40 tokens, M = 80 > 64, so its prefill takes W4A16 while
its decode stays W4A8).

Tolerances (max |port - JAX| of logits, whose std is ~0.2-0.3): float 1e-5,
from f32 sums in another order (measured 1.6e-6). The int8 arms 3e-2: they
agree to ~1e-6 until a last-bit difference lands an activation on the other
side of a rounding boundary (XLA's and PyTorch's CPU kernels sum in
different orders); that moves one int8 step, and one step moves these
logits by up to ~1e-2 (measured 9e-3 in the per-token decode step). The fp8
and int4 arms 0.1 for the same reason: one e4m3 step is 1/16-1/8 of the
value it rounds, and such a flip moved these logits by up to 0.047 (fp8
per-token prefill; int4 W4A8 0.021; fp8 static and e5m2 agreed to 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.kernels.fused import fused_add_rmsnorm_quant
from autosmoothquant_tpu_torch.models import common as TC
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.quant import math as tmath

from test_torch_util import (jax_llama, one_torch_thread, port_config,  # noqa: F401
                             port_qcfg, run_jax_cached, run_port_cached, to_numpy_tree)

ARMS = {
    "float": (None, jnp.float32, 1e-5),
    "int8_per_tensor": ({"type": "int8"}, jnp.float32, 3e-2),
    "int8_per_token": ({"type": "int8", "qkv": "per-token", "out": "per-token",
                        "fc1": "per-token", "fc2": "per-token"}, jnp.float32, 3e-2),
    "int8_kv": ({"type": "int8"}, jnp.int8, 3e-2),
    "fp8_per_tensor": ({"type": "fp8_e4m3"}, jnp.float32, 0.1),
    "fp8_per_token": ({"type": "fp8_e4m3", "qkv": "per-token", "out": "per-token",
                       "fc1": "per-token", "fc2": "per-token"}, jnp.float32, 0.1),
    "fp8_static": ({"type": "fp8_e4m3", "activation_scheme": "static"},
                   jnp.float32, 0.1),
    "fp8_e5m2": ({"type": "fp8_e5m2"}, jnp.float32, 0.1),
    "int4": ({"type": "int4"}, jnp.float32, 0.1),
    "int4_w4a16_prefill": ({"type": "int4"}, jnp.float32, 0.1),
}
# prompt length per arm (2 rows; default 24, so M = 48 <= 64)
PROMPT_LEN = {"int4_w4a16_prefill": 40}


def _port_kv(kv_dtype):
    return torch.int8 if kv_dtype == jnp.int8 else torch.float32


@pytest.mark.parametrize("arm,fused", [(a, False) for a in ARMS]
                         + [("float", True), ("int8_per_tensor", True)]
                         + [(a, True) for a in ARMS if a.startswith(("fp8", "int4"))])
def test_forward_matches_jax(arm, fused, monkeypatch):
    qkw, kv_dtype, tol = ARMS[arm]
    monkeypatch.setenv("ASQ_FUSED_BLOCK", "force")
    jax.clear_caches()
    JL, cfg, params, qcfg = jax_llama(qkw, seed=1)
    if fused:
        params = JL.fuse_decode_projections(params)
    ids = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, PROMPT_LEN.get(arm, 24))).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JL, cfg, params, qcfg, ids, kv_dtype)
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    t_pre, t_dec = run_port_cached(TL, port_config(cfg), tparams, port_qcfg(qcfg),
                                   ids, _port_kv(kv_dtype), tok)
    np.testing.assert_allclose(t_pre, j_pre, atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


@pytest.mark.parametrize("arm", ["float", "int8_per_tensor"])
def test_ragged_prefill_matches_jax_on_valid_rows(arm):
    """Left-padded prompts: the port takes banded flash attention with the
    pad lengths as row starts; JAX (on the CPU) its eager masked path."""
    qkw, kv_dtype, tol = ARMS[arm]
    JL, cfg, params, qcfg = jax_llama(qkw, seed=3)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    pads = np.asarray([0, 5, 13], np.int32)
    positions = np.maximum(np.arange(20)[None, :] - pads[:, None], 0).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JL, cfg, params, qcfg, ids, kv_dtype,
                                       pad_starts=jnp.asarray(pads),
                                       positions=jnp.asarray(positions))
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    t_pre, t_dec = run_port_cached(TL, port_config(cfg), tparams, port_qcfg(qcfg),
                                   ids, _port_kv(kv_dtype), tok,
                                   pad_starts=pads, positions=positions)
    valid = np.arange(20)[None, :] >= pads[:, None]
    np.testing.assert_allclose(t_pre[valid], j_pre[valid], atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


def test_cacheless_forward_matches_jax():
    JL, cfg, params, qcfg = jax_llama({"type": "int8"}, seed=5)
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    h, _, _ = JL.forward_jit(params, jnp.asarray(ids), cfg, qcfg)
    j = np.asarray(JL.logits(params, h))
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    th, cache = TL.forward(tparams, torch.from_numpy(ids).long(), port_config(cfg),
                           port_qcfg(qcfg))
    assert cache is None
    np.testing.assert_allclose(TL.logits(tparams, th).numpy(), j, atol=3e-2, rtol=0)


def test_fused_block_gives_the_unfused_chain_int8():
    """The fused add+RMSNorm+quant route equals rms_norm followed by
    quantize_act_prescaled, bit for bit, on the int8 it feeds gate|up."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(40, 256)).astype(np.float32) * 3)
    x = torch.from_numpy(rng.normal(size=(40, 256)).astype(np.float32))
    g = torch.from_numpy((rng.random(256) * 40 + 5).astype(np.float32))
    s, q = fused_add_rmsnorm_quant(h, x, g, eps=1e-6)
    chain = tmath.quantize_act_prescaled(TC.rms_norm(h + x, g, 1e-6))
    torch.testing.assert_close(s, h + x, rtol=0, atol=0)
    torch.testing.assert_close(q, chain, rtol=0, atol=0)


def test_fused_and_unfused_routes_give_the_same_logits():
    JL, cfg, params, qcfg = jax_llama({"type": "int8"}, seed=8)
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    tcfg, tq = port_config(cfg), port_qcfg(qcfg)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12)))
    fused, _ = TL.forward(tparams, ids, tcfg, tq)
    # the same layers through the unfused chain: rms_norm, then a POST_NORM
    # quant_linear for gate and up
    orig = TC.fused_block_enabled
    try:
        TL.fused_block_enabled = lambda *a, **k: False
        unfused, _ = TL.forward(tparams, ids, tcfg, tq)
    finally:
        TL.fused_block_enabled = orig
    torch.testing.assert_close(fused, unfused, rtol=0, atol=0)


def test_fuse_decode_projections_matches_jax_layout():
    JL, cfg, params, qcfg = jax_llama({"type": "int8"}, seed=10)
    fused_j = params_from_jax(to_numpy_tree(JL.fuse_decode_projections(params)),
                              device="cpu")
    fused_t = TL.fuse_decode_projections(params_from_jax(to_numpy_tree(params),
                                                               device="cpu"))
    for a, b in zip(fused_j["layers"], fused_t["layers"]):
        for grp, key in (("attn", "qkv"), ("mlp", "gateup")):
            for leaf in ("w", "dequant_scale"):
                torch.testing.assert_close(a[grp][key][leaf], b[grp][key][leaf],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("qkw", [{"type": "fp8_e4m3"}, {"type": "fp8_e5m2"},
                                 {"type": "int4"}], ids=["fp8", "e5m2", "int4"])
def test_fuse_decode_projections_matches_jax_layout_fp8_int4(qkw):
    """The port fuses fp8 and int4 as JAX does: weights and int4 group scales
    on N, fp8 w_scale expanded to a per-column vector, e5m2 scale-free."""
    JL, cfg, params, qcfg = jax_llama(qkw, seed=10)
    fused_j = params_from_jax(to_numpy_tree(JL.fuse_decode_projections(params)),
                              device="cpu")
    fused_t = TL.fuse_decode_projections(params_from_jax(to_numpy_tree(params),
                                                         device="cpu"))
    for a, b in zip(fused_j["layers"], fused_t["layers"]):
        for grp, key in (("attn", "qkv"), ("mlp", "gateup")):
            assert set(a[grp][key]) == set(b[grp][key])
            for leaf, t in a[grp][key].items():
                assert t.dtype == b[grp][key][leaf].dtype, (grp, leaf)
                assert torch.equal(_bits(t), _bits(b[grp][key][leaf])), (grp, leaf)


def _bits(t):
    """fp8 tensors compared by their bytes (torch.equal takes no fp8)."""
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn,
                                              torch.float8_e5m2) else t


@pytest.mark.parametrize("wdt", [torch.float8_e4m3fn, torch.float8_e5m2, torch.uint8])
def test_linear_routes_fp8_and_int4_weights_to_their_kernels(wdt, monkeypatch):
    """A quantized weight of any format reaches quant_linear (before the
    repair only int8 did, and fp8 or packed int4 bytes fell to
    float_linear); a float projection an ignore pattern exempted stays
    float under the same config."""
    calls = []
    monkeypatch.setattr(TC, "fp8_matmul", lambda *a, **k: calls.append("fp8")
                        or torch.zeros(3, 8))
    monkeypatch.setattr(TC, "int4_matmul", lambda *a, **k: calls.append("int4")
                        or torch.zeros(3, 8))
    qtype = {torch.float8_e4m3fn: "fp8_e4m3", torch.float8_e5m2: "fp8_e5m2",
             torch.uint8: "int4"}[wdt]
    qcfg = TC.QuantConfig(type=qtype)
    x = torch.ones(3, 16)
    if wdt == torch.uint8:
        p = {"w": torch.zeros(8, 8, dtype=torch.uint8), "w_scales": torch.ones(8, 1)}
    else:
        p = {"w": torch.zeros(8, 16).to(wdt), "w_scale": torch.tensor(1.0)}
    assert TC.is_quantized(p)
    TC.linear(x, p, qcfg)
    assert calls == ["int4" if wdt == torch.uint8 else "fp8"]
    float_out = TC.linear(x, {"w": torch.ones(16, 8)}, qcfg)
    assert calls == ["int4" if wdt == torch.uint8 else "fp8"]
    torch.testing.assert_close(float_out, torch.full((3, 8), 16.0))


def test_fuse_keeps_mixed_sections_unfused():
    """q left float by an fp8 ignore pattern beside fp8 k/v: q|k|v stays
    unfused (no concatenation across weight types), gate|up fuses."""
    f8 = lambda n, k: {"w": torch.ones(n, k).to(torch.float8_e4m3fn),  # noqa: E731
                       "w_scale": torch.tensor(0.5)}
    layer = {"ln1": {"w": torch.ones(16)}, "ln2": {"w": torch.ones(16)},
             "attn": {"q": {"w": torch.ones(16, 16)}, "k": f8(8, 16),
                      "v": f8(8, 16), "o": f8(16, 16)},
             "mlp": {"gate": f8(32, 16), "up": f8(32, 16), "down": f8(16, 32)}}
    out = TL.fuse_decode_projections({"layers": [layer]})["layers"][0]
    assert set(out["attn"]) == {"q", "k", "v", "o"}
    assert set(out["mlp"]) == {"gateup", "down"}
    assert out["mlp"]["gateup"]["w"].shape == (64, 16)
    torch.testing.assert_close(out["mlp"]["gateup"]["w_scale"], torch.full((64,), 0.5))
