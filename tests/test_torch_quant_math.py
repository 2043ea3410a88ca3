"""The port's QuantConfig and int8 quantization math against the JAX
package's: bit-exact, including round-half-to-even ties."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.quant import config as jcfg
from autosmoothquant_tpu.quant import math as jm
from autosmoothquant_tpu_torch.quant import config as tcfg
from autosmoothquant_tpu_torch.quant import math as tm


def _ties(shape, seed, scale=1.0):
    """Random values with exact .5 ties mixed in (after dividing by scale)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 60
    ties = (rng.integers(-140, 140, size=shape) + 0.5).astype(np.float32)
    pick = rng.random(shape) < 0.3
    return np.where(pick, ties * scale, x * scale).astype(np.float32)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_round_is_half_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.5])
    assert torch.round(x).tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 126.0, -128.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_prescaled_and_static_bit_exact(seed):
    x = _ties((8, 64), seed)
    _eq(tm.quantize_act_prescaled(torch.from_numpy(x)).numpy(),
        jm.quantize_act_prescaled(jnp.asarray(x)))
    s = np.float32(0.5)
    _eq(tm.quantize_act_static(torch.from_numpy(x), torch.tensor(s)).numpy(),
        jm.quantize_act_static(jnp.asarray(x), s))


@pytest.mark.parametrize("seed", [2, 3])
def test_dynamic_activation_quant_bit_exact(seed):
    x = _ties((6, 48), seed)
    x[0] = 0.0                      # exercises the 1e-8 floor
    q, s = tm.quantize_act_per_token(torch.from_numpy(x))
    jq, js = jm.quantize_act_per_token(jnp.asarray(x))
    _eq(q.numpy(), jq)
    _eq(s.numpy(), js)
    q, s = tm.quantize_act_per_tensor_dynamic(torch.from_numpy(x))
    jq, js = jm.quantize_act_per_tensor_dynamic(jnp.asarray(x))
    _eq(q.numpy(), jq)
    _eq(s.numpy(), js)


def test_weight_quant_bit_exact():
    w = _ties((32, 16), 4)
    q, s = tm.quantize_weight_per_tensor_absmax(torch.from_numpy(w))
    jq, js = jm.quantize_weight_per_tensor_absmax(jnp.asarray(w))
    _eq(q.numpy(), jq)
    _eq(s.numpy(), js)
    q, s = tm.quantize_weight_per_channel_absmax(torch.from_numpy(w))
    jq, js = jm.quantize_weight_per_channel_absmax(jnp.asarray(w))
    _eq(q.numpy(), jq)
    _eq(s.numpy(), js)
    ws = [w, _ties((32, 16), 5)]
    qs, s = tm.quantize_weight_fused_absmax([torch.from_numpy(a) for a in ws])
    jqs, js = jm.quantize_weight_fused_absmax([jnp.asarray(a) for a in ws])
    for a, b in zip(qs, jqs):
        _eq(a.numpy(), b)
    _eq(s.numpy(), js)


def test_dequantize_matches():
    rng = np.random.default_rng(6)
    q = rng.integers(-128, 128, size=(4, 8)).astype(np.int32)
    ws = rng.random(8).astype(np.float32)
    a = rng.random(4).astype(np.float32)
    np.testing.assert_array_equal(
        tm.dequantize_w_per_channel_a_per_token(
            torch.from_numpy(q), torch.from_numpy(ws), torch.from_numpy(a)).numpy(),
        np.asarray(jm.dequantize_w_per_channel_a_per_token(
            jnp.asarray(q), jnp.asarray(ws), jnp.asarray(a))))
    np.testing.assert_array_equal(
        tm.dequantize_w_per_channel_a_per_tensor(
            torch.from_numpy(q), torch.from_numpy(ws), torch.tensor(0.25)).numpy(),
        np.asarray(jm.dequantize_w_per_channel_a_per_tensor(
            jnp.asarray(q), jnp.asarray(ws), 0.25)))


@pytest.mark.parametrize("raw", [
    {"qkv": "per-token", "out": "per-tensor", "fc1": "per-token",
     "fc2": "per-tensor"},
    {"type": "fp8", "activation_scheme": "static"},
    {"type": "int4", "group_size": 64},
    {"type": "fp8_e5m2"},
])
def test_quant_config_contract_matches(raw, tmp_path):
    t, j = tcfg.QuantConfig.from_dict(raw), jcfg.QuantConfig.from_dict(raw)
    assert t.to_dict() == j.to_dict()
    assert (t.is_int8, t.is_fp8, t.is_int4) == (j.is_int8, j.is_fp8, j.is_int4)
    jcfg.save_quant_config(j, str(tmp_path / "q.json"))
    assert tcfg.parse_quant_config(str(tmp_path / "q.json")) == t
    tcfg.save_quant_config(t, str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "q.json"))
    if t.is_fp8:
        assert t.fp8_dtype == {"fp8_e4m3": torch.float8_e4m3fn,
                               "fp8_e5m2": torch.float8_e5m2}[t.type]


@pytest.mark.parametrize("bad", [{"qkv": "per-row"}, {"type": "int3"},
                                 {"type": "fp8_e5m2", "fc1": "per-token"}])
def test_quant_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jcfg.QuantConfig.from_dict(bad)
    with pytest.raises(ValueError):
        tcfg.QuantConfig.from_dict(bad)


# ---------------------------------------------------------------------------
# fp8 and int4 (byte-equal to the JAX package)
# ---------------------------------------------------------------------------

_FP8 = {"e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
        "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _fp8_input(shape, seed, dtype):
    """Normal draws over several decades, so that subnormal fp8 codes, the
    saturating clamp and ties all occur."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * np.exp(rng.uniform(-9, 3, size=shape))
    x = x.astype(np.float32)
    return x if dtype == "f32" else x.astype(jnp.bfloat16).astype(np.float32)


def _tbytes(t):
    return t.contiguous().view(torch.uint8).numpy()


def _jbytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_quant_bytes_equal_jax(fmt, dtype):
    tdt, jdt = _FP8[fmt]
    x = _fp8_input((16, 96), seed=len(fmt) + len(dtype), dtype=dtype)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "f32" else torch.bfloat16)
    jx = jnp.asarray(x, jnp.float32 if dtype == "f32" else jnp.bfloat16)
    q, s = tm.quantize_fp8_per_tensor(tx, tdt)
    jq, js = jm.quantize_fp8_per_tensor(jx, jdt)
    assert q.dtype == tdt
    np.testing.assert_array_equal(_tbytes(q), _jbytes(jq))
    _eq(s.numpy(), js)
    q, s = tm.quantize_fp8_per_token(tx, tdt)
    jq, js = jm.quantize_fp8_per_token(jx, jdt)
    np.testing.assert_array_equal(_tbytes(q), _jbytes(jq))
    _eq(s.numpy(), js)
    static = np.float32(0.0125)
    q = tm.quantize_fp8_static(tx, torch.tensor(static), tdt)
    jq = jm.quantize_fp8_static(jx, static, jdt)
    np.testing.assert_array_equal(_tbytes(q), _jbytes(jq))
    sub = tm.FP8_E4M3_MAX if fmt == "e4m3" else tm.FP8_E5M2_MAX
    assert sub == float(jnp.finfo(jdt).max)


def test_fp8_empty_tensor_guard():
    """The guard's amax of 16 (JAX's own reduction over an empty array raises
    before its guard is reached, so this is held against the value)."""
    q, s = tm.quantize_fp8_per_tensor(torch.zeros((0, 8)))
    assert q.shape == (0, 8) and q.dtype == torch.float8_e4m3fn
    _eq(s.numpy(), np.float32(16.0) / np.float32(448.0))


@pytest.mark.parametrize("k", [256, 768, 2048, 5632, 11008, 13824])
def test_int4_padded_k_matches_jax(k):
    assert tm.int4_padded_k(k) == jm.int4_padded_k(k)
    assert tm.int4_padded_k(k, 64) == jm.int4_padded_k(k, 64)


def test_int4_padded_k_known_depths():
    assert tm.int4_padded_k(5632) == 6144      # TinyLlama down_proj
    assert tm.int4_padded_k(11008) == 12288    # Llama-7B down_proj


@pytest.mark.parametrize("k,n,group,pad", [(768, 64, 128, True), (256, 48, 32, False),
                                           (512, 40, 64, True)])
def test_int4_quant_pack_bytes_equal_jax(k, n, group, pad):
    w = np.random.default_rng(k + n).normal(size=(k, n)).astype(np.float32)
    w[:, 0] = 0.0                                   # exercises the 1e-8 floor
    p, s = tm.quantize_weight_int4_grouped(torch.from_numpy(w), group, pad=pad)
    jp, js = jm.quantize_weight_int4_grouped(jnp.asarray(w), group, pad=pad)
    assert p.dtype == torch.uint8 and p.shape == jp.shape
    _eq(p.numpy(), jp)
    _eq(s.numpy(), js)
    lo, hi = tm.unpack_int4(p)
    jlo, jhi = jm.unpack_int4(jp)
    _eq(lo.numpy(), jlo)
    _eq(hi.numpy(), jhi)
    _eq(tm.dequantize_int4_grouped(p, s, torch.float32).numpy(),
        jm.dequantize_int4_grouped(jp, js, jnp.float32))


def test_int4_quant_rejects_what_jax_rejects():
    w = np.zeros((96, 8), np.float32)
    with pytest.raises(ValueError):
        jm.quantize_weight_int4_grouped(jnp.asarray(w), 64)
    with pytest.raises(ValueError):
        tm.quantize_weight_int4_grouped(torch.from_numpy(w), 64)


def test_fp8_per_token_zero_row_is_zero_not_nan():
    """The one place the port departs from JAX's fp8 math: an all-zero row
    (a left-pad row of the banded prefill) quantizes to 0 with scale 1, where
    JAX's scale is 0 and its 0 / 0 gives NaN values; every other row stays byte-equal."""
    x = _fp8_input((4, 32), seed=9, dtype="f32")
    x[2] = 0.0
    q, s = tm.quantize_fp8_per_token(torch.from_numpy(x))
    jq, js = jm.quantize_fp8_per_token(jnp.asarray(x))
    assert np.asarray(js)[2, 0] == 0.0
    assert np.isnan(np.asarray(jq[2]).astype(np.float32)).all()
    assert s[2, 0] == 1.0 and not q[2].float().any()
    keep = [0, 1, 3]
    np.testing.assert_array_equal(_tbytes(q)[keep], _jbytes(jq)[keep])
    _eq(s.numpy()[keep], np.asarray(js)[keep])


def _exact_sqrt(x):
    return np.sqrt(x.astype(np.float64)).astype(np.float32)


def _exact_rsqrt(x):
    return (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)


def _two_rsqrt(x):
    """1 / sqrt(x) as two correctly rounded f32 operations (numpy's f32 sqrt
    and division are IEEE's)."""
    return (np.float32(1) / np.sqrt(x)).astype(np.float32)


def _host_inputs():
    """4096 seeded f32 values over the ranges the norms and the smoothing see
    (variances plus eps, absmax statistics), whole binades of both parities
    of exponent included."""
    rng = np.random.default_rng(11)
    return np.concatenate([rng.uniform(0.1, 4.0, 2048),
                           np.exp(rng.uniform(np.log(1e-6), np.log(1e4), 2048))]
                          ).astype(np.float32)


@pytest.mark.parametrize("which", ["sqrt", "rsqrt", "recip_sqrt"])
def test_plain_sqrt_and_rsqrt_are_correctly_rounded_on_this_host(which):
    """The port's plain square roots (the smoothing's ``sqrt_rn``), the
    correctly rounded reciprocal square root (LayerNorm's ``rsqrt_rn``) and
    the reciprocal of the correctly rounded square root (RMSNorm's
    ``recip_sqrt_rn``, the kernels' ``1.f / sqrtf``) equal their exactly
    rounded definitions: torch's own f32 ``sqrt`` is not correctly rounded
    on every CPU (an ulp off in hundreds of these values on an AVX-512 host),
    and an ulp there flips int8 roundings downstream. A host whose torch
    rounds these differently fails here rather than in a perplexity."""
    x = _host_inputs()
    fn, want = {"sqrt": (tm.sqrt_rn, _exact_sqrt), "rsqrt": (tm.rsqrt_rn, _exact_rsqrt),
                "recip_sqrt": (tm.recip_sqrt_rn, _two_rsqrt)}[which]
    _eq(fn(torch.from_numpy(x)).numpy(), want(x))


def test_plain_norms_take_the_correctly_rounded_rsqrt():
    """LayerNorm and K6's plain version scale each row by the correctly
    rounded 1 / sqrt(var + eps) of their own variance; RMSNorm and K2's plain
    version by the reciprocal of its correctly rounded square root (the
    kernels' bits); the smoothing's alpha-0.5 scales are quotients of
    correctly rounded square roots."""
    from autosmoothquant_tpu_torch.kernels import fused
    from autosmoothquant_tpu_torch.models.common import layer_norm
    from autosmoothquant_tpu_torch.quant.smooth import compute_smooth_scale

    rng = np.random.default_rng(12)
    x = rng.normal(size=(512, 64)).astype(np.float32)
    ones = torch.ones(64)
    xt = torch.from_numpy(x)
    var = (xt * xt).mean(dim=-1, keepdim=True).numpy()
    _eq(fused.rms_norm(xt, ones, 1e-6).numpy(), x * _two_rsqrt(var + np.float32(1e-6)))
    c = xt - xt.mean(dim=-1, keepdim=True)
    cv = (c * c).mean(dim=-1, keepdim=True).numpy()
    want = c.numpy() * _exact_rsqrt(cv + np.float32(1e-5))
    _eq(layer_norm(xt, ones, torch.zeros(64), 1e-5).numpy(), want)
    zero = torch.zeros_like(xt)
    h, q = fused.fused_add_layernorm_quant_plain(xt, zero, ones * 20, torch.zeros(64), eps=1e-5)
    _eq(q.numpy(), np.clip(np.round(want * np.float32(20)), -128, 127).astype(np.int8))
    h, q = fused.fused_add_rmsnorm_quant_plain(xt, zero, ones * 20, eps=1e-6)
    want = x * _two_rsqrt(var + np.float32(1e-6)) * np.float32(20)
    _eq(q.numpy(), np.clip(np.round(want), -128, 127).astype(np.int8))
    act = np.abs(rng.normal(size=64)).astype(np.float32) + 0.1
    w = rng.normal(size=(64, 32)).astype(np.float32)
    wmax = np.maximum(np.abs(w).max(axis=1), np.float32(1e-5))
    _eq(compute_smooth_scale(torch.from_numpy(act), [torch.from_numpy(w)]).numpy(),
        np.maximum(_exact_sqrt(act) / _exact_sqrt(wmax), np.float32(1e-5)))
