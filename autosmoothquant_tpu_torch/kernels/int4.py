"""int4 weight GEMM over split-K nibble-packed weights: the port of
``autosmoothquant_tpu/kernels/int4.py`` (``int4_matmul``).

Routing follows the JAX package exactly, on M, the row count of the
flattened ``[B*T, K]`` input (``_A8_MAX_M``):
  - M <= 64 (decode at any batch up to 64): W4A8. x is quantized per token
    to int8 and multiplied against the nibbles group by group. CUDA tensors
    launch ``csrc/int4_gemm.cu`` (K5); CPU tensors run
    :func:`int4_matmul_plain`.
  - M > 64 (prefill): W4A16, :func:`int4_matmul_w4a16`: the weight is
    dequantized and one matrix product runs, in bf16 with f32 accumulation on
    the card when x is bf16 and in f32 otherwise (the JAX package: bf16 on
    its accelerator, f32 on the CPU). This is what the JAX package computes
    outside any Pallas kernel (``int4_matmul_xla``), so it stays plain torch.

Layout: packed uint8 ``[N, K'/2]`` and scales f32 ``[N, G]`` (see
``convert/from_jax.py``); byte r of column n holds row r (low nibble) and
row r + K'/2 (high nibble), each stored as q + 8. K' >= K is the artifact's
zero-padded depth (``quant.math.int4_padded_k``); x keeps its true K and the
missing columns count as zero.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..quant import math as qmath
from . import _build
from .gemm import _ACTS

# M at or below this takes W4A8 (K5 on the card); above it W4A16
_A8_MAX_M = 64

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)


def _epilogue(out, bias, activation, out_dtype):
    if bias is not None:
        out = out + bias.float().reshape(1, -1)
    if activation == "silu":
        out = out * torch.sigmoid(out)
    elif activation == "relu":
        out = torch.clamp_min(out, 0.0)
    return out.to(out_dtype)


def _unpacked(packed: torch.Tensor) -> torch.Tensor:
    """[N, K'/2] packed -> [N, K'] signed int8 (the split-K halves side by
    side)."""
    lo, hi = qmath.unpack_int4(packed)
    return torch.cat([lo, hi], dim=1)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, activation: Optional[str] = None,
                      out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of K5, the W4A8 branch of the JAX package's
    ``int4_matmul_xla``: per-token int8 x, exact per-group integer products,
    then ``sum_g(part * scale) * tok_scale`` in f32. The products are exact
    in f32 on the CPU (|part| <= 128 * 8 * group, far below 2**24); on a
    CUDA tensor they run in float64, equally exact."""
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    n, k2 = packed.shape
    kp, g = 2 * k2, scales.shape[1]
    if k < kp:
        x = F.pad(x, (0, kp - k))
    q, tok_scale = qmath.quantize_act_per_token(x)
    xg = q.reshape(m, g, kp // g)
    wg = _unpacked(packed).reshape(n, g, kp // g)
    ct = torch.float64 if x.is_cuda else torch.float32
    part = torch.einsum("mgk,ngk->mgn", xg.to(ct), wg.to(ct)).float()
    out = (part * scales.t()[None]).sum(dim=1) * tok_scale
    return _epilogue(out, bias, activation, out_dtype)


def int4_matmul_w4a16(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, activation: Optional[str] = None,
                      out_dtype=None) -> torch.Tensor:
    """The prefill route (M > 64): dequantize, then one product with f32
    accumulation. The padded weight columns meet zero activations, so they
    are cut rather than x padded."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[1]
    group = 2 * packed.shape[1] // scales.shape[1]
    cdt = torch.bfloat16 if (x.is_cuda and x.dtype == torch.bfloat16) else torch.float32
    w = (_unpacked(packed).float()
         * scales.repeat_interleave(group, dim=1))[:, :k].to(cdt)
    if cdt == torch.float32:
        acc = x.float() @ w.t()
    else:
        acc = torch.mm(x, w.t(), out_dtype=torch.float32)
    return _epilogue(acc, bias, activation, out_dtype)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                activation: Optional[str] = None, out_dtype=None) -> torch.Tensor:
    """``act(x @ dequant(packed, scales).T + bias)`` in ``out_dtype``
    (default x's dtype), routed on M as the JAX package routes it.

    x: f32 or bf16 [M, K]; packed: uint8 [N, K'/2] with K <= K'; scales: f32
    [N, G], group = K' / G; bias: f32 [N] or None; activation: None, "relu"
    or "silu"."""
    if packed.dtype != torch.uint8 or packed.ndim != 2:
        raise TypeError(f"packed must be uint8 [N, K'/2], got {packed.dtype} "
                        f"{tuple(packed.shape)}")
    if x.dtype not in _OUT_KINDS or x.ndim != 2:
        raise TypeError(f"x must be f32 or bf16 [M, K], got {x.dtype} "
                        f"{tuple(x.shape)}")
    m, k = x.shape
    n, k2 = packed.shape
    if (scales.dtype != torch.float32 or scales.ndim != 2
            or scales.shape[0] != n or (2 * k2) % scales.shape[1]):
        raise ValueError(f"scales {scales.dtype} {tuple(scales.shape)} do not "
                         f"fit packed {tuple(packed.shape)}")
    if k > 2 * k2:
        raise ValueError(f"x has K={k} columns; packed stores {2 * k2}")
    out_dtype = out_dtype or x.dtype
    if activation not in _ACTS or out_dtype not in _OUT_KINDS:
        raise ValueError(f"activation={activation!r} out_dtype={out_dtype}")
    if m > _A8_MAX_M:
        return int4_matmul_w4a16(x, packed, scales, bias,
                                 activation=activation, out_dtype=out_dtype)
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales, bias,
                                 activation=activation, out_dtype=out_dtype)
    dev = x.device
    if packed.device != dev or scales.device != dev:
        raise ValueError("x, packed and scales must be on one device")
    x = x.contiguous()
    packed = packed.contiguous()
    scales = scales.contiguous()
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous().reshape(n)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    xq = torch.empty((m, 2 * k2), dtype=torch.int8, device=dev)
    tok_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    fn = _build.function("int4_gemm", "asq_int4_gemm", _ARGTYPES)
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scales.data_ptr(), _build.ptr(bias), out.data_ptr(), xq.data_ptr(),
            tok_scale.data_ptr(), m, n, k, k2, scales.shape[1],
            _ACTS[activation], _OUT_KINDS[out_dtype], _build.stream_ptr(x))
    _build.check("int4_gemm", rc, "int4_matmul")
    int4_matmul.launches += 1
    return out


# calls that launched K5 on the card (each launches its quantize and its GEMM
# kernel; plain CPU calls and the W4A16 route do not count)
int4_matmul.launches = 0
