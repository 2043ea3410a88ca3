"""Quantization math over torch tensors (the port of
``autosmoothquant_tpu/quant/math.py``: int8, fp8 and grouped int4),
bit-exact against it:

  - symmetric absmax int8: scale = absmax / 127, q = round(x / scale)
  - activation scales floored at 1e-8 before the /127 divide
  - round half to even (``torch.round`` is half-even, like ``jnp.round``),
    then clamp to [-128, 127]
  - fp8: divide by the scale (never multiply by a reciprocal), clamp to
    +-finfo.max, then cast (the cast rounds to nearest even, as jnp's does)
  - int4: per-group absmax / 7 scales, offset-binary nibbles packed split-K

Every function runs in f32 and keeps scales as device tensors: nothing here
reads a value back to the host. Division by a constant goes through
:func:`true_div`: on a CUDA tensor PyTorch turns ``x / 127.0`` into a
product with the rounded reciprocal, which is not the true quotient that
JAX and the CPU compute.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

INT8_MAX = 127.0
INT8_MIN = -128.0
FP8_E4M3_MAX = float(torch.finfo(torch.float8_e4m3fn).max)  # 448
FP8_E5M2_MAX = float(torch.finfo(torch.float8_e5m2).max)    # 57344


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded once, as IEEE division rounds it, on every device
    (the divisor is a 0-d tensor on x's device, which CUDA divides truly;
    a 0-d divisor leaves x's dtype as it is)."""
    return x / _const(float(value), x.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 square root of ``x``, correctly rounded on every host: taken in
    f64 and rounded once to f32 (exact for f32 inputs, since f64 carries
    more than twice f32's bits). torch's f32 ``sqrt`` on some CPUs is not
    correctly rounded (an ulp off in about one value in six on an AVX-512
    host); CUDA's f32 and f64 ``sqrt`` are."""
    return torch.sqrt(x.double()).float()


def rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 ``1 / sqrt(x)`` rounded once from its f64 value: on every f32 in
    [1, 4) the same as from an 80-bit extended value (checked exhaustively;
    other binades scale by powers of 4 exactly), so correctly rounded for
    normal results: LayerNorm's inverse root (the plain versions and K6,
    ``csrc/asq_common.cuh:asq_rsqrt_rn``, take these bits)."""
    return (1.0 / torch.sqrt(x.double())).float()


def recip_sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 ``1 / sqrt(x)`` as two correctly rounded f32 operations, the
    square root (:func:`sqrt_rn`) then the division: RMSNorm's inverse root,
    the bits of K2's and ``rmsnorm_quant``'s ``1.f / sqrtf`` (torch's CPU
    ``rsqrt`` gives them too on an AVX-512 host, but its ``sqrt`` does not
    round correctly there). It parts from :func:`rsqrt_rn` in about one value
    in four."""
    return torch.reciprocal(sqrt_rn(x))


def _round_clamp(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), INT8_MIN, INT8_MAX).to(torch.int8)


# ---------------------------------------------------------------------------
# weights (offline)
# ---------------------------------------------------------------------------


def quantize_weight_per_tensor_absmax(w: torch.Tensor):
    """Returns (int8 values, f32 0-d scale)."""
    scale = true_div(w.abs().max().float(), INT8_MAX)
    return _round_clamp(w.float() / scale), scale


def quantize_weight_fused_absmax(ws):
    """One shared scale for several same-shaped weights (fused QKV)."""
    scale = torch.zeros((), dtype=torch.float32, device=ws[0].device)
    for w in ws:
        scale = torch.maximum(scale, true_div(w.abs().max().float(), INT8_MAX))
    return [_round_clamp(w.float() / scale) for w in ws], scale


def quantize_weight_per_channel_absmax(w: torch.Tensor, axis: int = 0):
    """Per-output-channel scales; reduces over ``axis`` (the input dim of an
    [in, out] weight by default)."""
    scales = true_div(w.abs().amax(dim=axis, keepdim=True).float(), INT8_MAX)
    return _round_clamp(w.float() / scales), scales


# ---------------------------------------------------------------------------
# activations (runtime)
# ---------------------------------------------------------------------------


def quantize_act_per_token(x: torch.Tensor, absmax: Optional[torch.Tensor] = None):
    """Dynamic per-token absmax over the last dim (or ``absmax`` [..., 1]
    given: a row-parallel slice's whole-row absmax). Returns (int8, f32
    [..., 1])."""
    if absmax is None:
        absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = true_div(torch.clamp(absmax.float(), min=1e-8), INT8_MAX)
    return _round_clamp(x.float() / scale), scale


def quantize_act_per_tensor_dynamic(x: torch.Tensor):
    absmax = x.abs().max()
    scale = true_div(torch.clamp(absmax.float(), min=1e-8), INT8_MAX)
    return _round_clamp(x.float() / scale), scale


def quantize_act_static(x: torch.Tensor, quant_scale) -> torch.Tensor:
    """Static per-tensor quant with a known (device) scale."""
    return _round_clamp(x.float() / quant_scale)


def quantize_act_prescaled(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor quant whose 1/scale is folded into the preceding norm."""
    return _round_clamp(x.float())


def fake_quantize_act_per_token(x: torch.Tensor) -> torch.Tensor:
    """Per-token int8 round trip in x's dtype (the fake-quant study path)."""
    q, scale = quantize_act_per_token(x)
    return (q.float() * scale).to(x.dtype)


def fake_quantize_act_per_tensor(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor dynamic int8 round trip in x's dtype."""
    q, scale = quantize_act_per_tensor_dynamic(x)
    return (q.float() * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# dequantization
# ---------------------------------------------------------------------------


def dequantize_w_per_channel_a_per_token(q, w_scales, a_scales,
                                         dtype=torch.float32):
    """out[i,j] = q[i,j] * w_scales[j] * a_scales[i]."""
    out = q.float() * w_scales.reshape(1, -1) * a_scales.reshape(-1, 1)
    return out.to(dtype)


def dequantize_w_per_channel_a_per_tensor(q, w_scales, a_scale,
                                          dtype=torch.float32):
    out = q.float() * w_scales.reshape(1, -1) * a_scale
    return out.to(dtype)


# ---------------------------------------------------------------------------
# fp8 (e4m3 with scales; e5m2 is a scale-free cast done by the caller)
# ---------------------------------------------------------------------------


def quantize_fp8_per_tensor(x: torch.Tensor, dtype=torch.float8_e4m3fn,
                            amax: Optional[torch.Tensor] = None):
    """Per-tensor fp8 with a saturating clamp (``amax`` f32 0-d given: the
    whole tensor's, for a row-parallel slice). Returns (fp8, f32 0-d
    scale)."""
    fmax = float(torch.finfo(dtype).max)
    if amax is None and x.numel() == 0:
        # the reference's empty-tensor guard (empty MoE experts)
        amax = torch.tensor(16.0, dtype=torch.float32, device=x.device)
    elif amax is None:
        amax = x.abs().max().float()
    scale = true_div(amax, fmax)
    return torch.clamp(x.float() / scale, -fmax, fmax).to(dtype), scale


def quantize_fp8_per_token(x: torch.Tensor, dtype=torch.float8_e4m3fn,
                           absmax: Optional[torch.Tensor] = None):
    """Per-token fp8. Returns (fp8, f32 [..., 1]); the divide by fmax runs in
    x's dtype, as the JAX package runs it.

    One difference by design: an all-zero row gets the scale 1 (its values
    quantize to 0 either way), where JAX divides 0 by 0 and returns NaN. The
    port's banded prefill writes left-pad rows as 0, and a NaN there would
    reach valid rows through the masked cache slots. ``absmax`` [..., 1] in
    x's dtype, where given, is the whole row's (a row-parallel slice)."""
    fmax = float(torch.finfo(dtype).max)
    if absmax is None:
        absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = true_div(absmax, fmax).float()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(x.float() / scale, -fmax, fmax).to(dtype), scale


def quantize_fp8_static(x: torch.Tensor, scale, dtype=torch.float8_e4m3fn):
    """Static fp8 with a frozen (device) scale."""
    fmax = float(torch.finfo(dtype).max)
    return torch.clamp(x.float() / scale, -fmax, fmax).to(dtype)


def fake_quantize_fp8_per_tensor(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    """Per-tensor fp8 round trip in x's dtype."""
    q, scale = quantize_fp8_per_tensor(x, dtype)
    return (q.float() * scale).to(x.dtype)


def fake_quantize_fp8_per_token(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    """Per-token fp8 round trip in x's dtype (an all-zero row stays 0, see
    :func:`quantize_fp8_per_token`)."""
    q, scale = quantize_fp8_per_token(x, dtype)
    return (q.float() * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# int4 weight-only group quantization (the JAX package's deployment format)
# ---------------------------------------------------------------------------

INT4_MAX = 7.0
INT4_GROUP_DEFAULT = 128

# Relative per-byte cost of the JAX package's W4A8 TPU kernel by k-block
# depth. It decides the zero padding of K in the artifact, so the port keeps
# it as part of the format: int4_padded_k must give the depth JAX stored.
_INT4_HK_COST = {128: 3.4, 256: 2.0, 512: 1.5, 1024: 1.1, 2048: 1.0}


def int4_padded_k(K: int, group_size: int = INT4_GROUP_DEFAULT) -> int:
    """The stored depth K' >= K of an int4 weight (a multiple of
    2 * group_size), e.g. 5632 -> 6144 and 11008 -> 12288 at group 128."""
    best = None
    hk = group_size
    while True:
        kp = -(-K // (2 * hk)) * (2 * hk)
        cost = kp * _INT4_HK_COST.get(hk, 1.0 if hk >= 2048 else 4.0)
        if best is None or cost < best[0] or (cost == best[0] and kp < best[1]):
            best = (cost, kp)
        if hk >= 2048:
            break
        hk *= 2
    return best[1]


def quantize_weight_int4_grouped(w: torch.Tensor,
                                 group_size: int = INT4_GROUP_DEFAULT,
                                 pad: bool = True):
    """Symmetric per-group absmax int4 quant with split-K nibble packing, in
    the JAX package's layout.

    w: [K, N] float (K = input dim). With ``pad``, K is zero-padded to
    ``int4_padded_k(K)``. Byte r of column n holds row r (low nibble) and
    row r + K'/2 (high nibble), each stored as q + 8 (offset binary).
    Returns (packed uint8 [K'/2, N], scales f32 [K'/group_size, N])."""
    K, N = w.shape
    if group_size % 2 or K % group_size or (K // 2) % group_size:
        raise ValueError(
            f"K={K} and K/2 must be multiples of even group_size={group_size}")
    if pad:
        kp = int4_padded_k(K, group_size)
        if kp > K:
            w = torch.cat([w, torch.zeros((kp - K, N), dtype=w.dtype,
                                          device=w.device)], dim=0)
            K = kp
    wf = w.float().reshape(K // group_size, group_size, N)
    scales = torch.clamp_min(true_div(wf.abs().amax(dim=1), INT4_MAX), 1e-8)
    q = torch.clamp(torch.round(wf / scales[:, None, :]), -8, 7)
    nib = (q.reshape(K, N) + 8.0).to(torch.int32)
    half = K // 2
    return (nib[:half] | (nib[half:] << 4)).to(torch.uint8), scales


def unpack_int4(packed: torch.Tensor):
    """uint8 packed -> (lo, hi) int8 signed values (offset removed),
    elementwise, so it serves either layout: lo holds the first K'/2 rows,
    hi the last."""
    p = packed.to(torch.int32)
    return ((p & 0xF) - 8).to(torch.int8), ((p >> 4) - 8).to(torch.int8)


def dequantize_int4_grouped(packed: torch.Tensor, scales: torch.Tensor,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_weight_int4_grouped (JAX layout): [K', N]."""
    lo, hi = unpack_int4(packed)
    k2, n = packed.shape
    g = scales.shape[0]
    q = torch.cat([lo, hi], dim=0)
    qf = q.reshape(g, (2 * k2) // g, n).float() * scales[:, None, :]
    return qf.reshape(2 * k2, n).to(dtype)
