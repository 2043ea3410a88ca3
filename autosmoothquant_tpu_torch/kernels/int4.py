"""int4 weight GEMM over split-K nibble-packed weights: the port of
``autosmoothquant_tpu/kernels/int4.py`` (``int4_matmul``).

Routing follows the JAX package on M, the row count of the flattened
``[B*T, K]`` input (``_A8_MAX_M``):
  - M <= 64 (decode at any batch up to 64, prompts of up to 64 tokens in
    all): W4A8. x is quantized per token to int8 and multiplied against the
    nibbles group by group. CUDA tensors launch ``csrc/int4_gemm.cu`` (K5)
    on one of three routes, picked by :func:`route` from the shape alone:
    "gemv" (M <= 4 for f32 x, M <= 2 for bf16: one launch, the quantize
    fused in), "tc" (9 <= M: int8 tensor cores after a quantize launch, K
    split by :func:`tc_split` where the output has few tiles; counted apart
    in ``int4_matmul.tc_launches``) or "tiles" (CUDA-core columns after a
    quantize launch, for the shapes the other two do not take). CPU tensors run :func:`int4_matmul_plain`.
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
from .gemm import _ACTS, tc_split

# M at or below this takes W4A8 (K5 on the card); above it W4A16
_A8_MAX_M = 64
# the largest M the GEMV takes, by x's dtype. Every GEMV block quantizes all
# M rows itself, so its prologue grows with M; past these M it loses to the
# tiles route's one quantize launch (an H100, chip_smoke.py's K5 timing rows
# beside tiles_route_ms), and sooner for bf16 rows, whose prologue costs more
GEMV_MAX_M = {torch.float32: 4, torch.bfloat16: 2}
# the tensor cores from this M on (one 64-row block tile; below it the tiles)
_TC_MIN_M = 9
# x_q bytes (M * K') a GEMV block keeps in shared memory (int4_gemm.cu)
_GEMV_MAX_XQ = 64 * 1024

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, x_is_bf16, packed, scales, bias, tok_scale, out, [xq, ts,] M, N, K, K2, G,
# act, out_kind, [split, ws,] stream
_ARGTYPES = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_GEMV_ARGTYPES = (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_TC_ARGTYPES = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)


def route(m: int, k2: int, group: int, x_dtype: torch.dtype,
          *tensors: torch.Tensor) -> str:
    """The route of an [m, K] x (of ``x_dtype``) times packed [N, k2]
    product with groups of ``group`` rows: "w4a16" (M > 64, plain torch),
    "gemv" (M <= ``GEMV_MAX_M[x_dtype]`` where x_q fits in a block's shared
    memory), "tc" (the tensor cores, M >= 9: a group of 32 rows or a
    multiple, so each 32-byte mma step lies inside one group, k2 a multiple
    of the group, so a step's low and high halves end their groups together,
    and 16-byte aligned ``tensors``, the packed weight, for cp.async) or
    "tiles" (CUDA-core columns, for the rest). The tensor-core route's K
    walk has the tile of K1's (``tc_split``: 128 packed bytes a stage, one
    64-row block for all M <= 64)."""
    if m > _A8_MAX_M:
        return "w4a16"
    if m <= GEMV_MAX_M[x_dtype] and k2 % 2 == 0 and m * 2 * k2 <= _GEMV_MAX_XQ:
        return "gemv"
    if (m >= _TC_MIN_M and group % 32 == 0 and k2 % group == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return "tc"
    return "tiles"


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
                      out_dtype=None, tok_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K5, the W4A8 branch of the JAX package's
    ``int4_matmul_xla``: per-token int8 x (against ``tok_scale`` [M] where
    given, else each row's own absmax scale), exact per-group integer
    products, then ``sum_g(part * scale) * tok_scale`` in f32. The products
    are exact in f32 on the CPU (|part| <= 128 * 8 * group, far below 2**24);
    on a CUDA tensor they run in float64, equally exact."""
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    n, k2 = packed.shape
    kp, g = 2 * k2, scales.shape[1]
    if k < kp:
        x = F.pad(x, (0, kp - k))
    if tok_scale is None:
        q, tok_scale = qmath.quantize_act_per_token(x)
    else:
        tok_scale = tok_scale.float().reshape(m, 1)
        q = qmath.quantize_act_static(x, tok_scale)
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
                activation: Optional[str] = None, out_dtype=None,
                tok_scale: Optional[torch.Tensor] = None,
                a8: Optional[bool] = None) -> torch.Tensor:
    """``act(x @ dequant(packed, scales).T + bias)`` in ``out_dtype``
    (default x's dtype), routed on M as the JAX package routes it.

    x: f32 or bf16 [M, K]; packed: uint8 [N, K'/2] with K <= K'; scales: f32
    [N, G], group = K' / G; bias: f32 [N] or None; activation: None, "relu"
    or "silu". ``a8`` (JAX's ``a8``) gives the W4A8 / W4A16 decision where
    the caller makes it (a rank's planes of a row-parallel product route on
    the whole product's M); None takes M <= 64. ``tok_scale`` (f32 [M]) gives
    W4A8's per-token scales on every route (the whole row's, for a rank's
    planes); None takes each row's own."""
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
    if a8 is None:
        a8 = m <= _A8_MAX_M
    if not a8:
        return int4_matmul_w4a16(x, packed, scales, bias,
                                 activation=activation, out_dtype=out_dtype)
    if m > _A8_MAX_M:
        raise ValueError(f"W4A8 takes at most {_A8_MAX_M} rows, not {m}")
    if tok_scale is not None and tok_scale.numel() != m:
        raise ValueError(f"tok_scale has {tok_scale.numel()} values for {m} rows")
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scales, bias, activation=activation,
                                 out_dtype=out_dtype, tok_scale=tok_scale)
    dev = x.device
    if packed.device != dev or scales.device != dev:
        raise ValueError("x, packed and scales must be on one device")
    x = x.contiguous()
    packed = packed.contiguous()
    scales = scales.contiguous()
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous().reshape(n)
    if tok_scale is not None:
        tok_scale = tok_scale.to(device=dev, dtype=torch.float32).contiguous().reshape(m)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    g = scales.shape[1]
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scales.data_ptr(), _build.ptr(bias), _build.ptr(tok_scale), out.data_ptr())
    tail = (m, n, k, k2, g, _ACTS[activation], _OUT_KINDS[out_dtype])
    how = route(m, k2, 2 * k2 // g, x.dtype, packed)
    if how == "gemv":
        fn = _build.function("int4_gemm", "asq_int4_gemv", _GEMV_ARGTYPES)
        rc = fn(*head, *tail, _build.stream_ptr(x))
    else:
        xq = torch.empty((m, 2 * k2), dtype=torch.int8, device=dev)
        ts_out = torch.empty((m,), dtype=torch.float32, device=dev)
        scratch = (xq.data_ptr(), ts_out.data_ptr())
        if how == "tc":
            split = tc_split(m, n, k2)
            ws = (torch.empty(split * m * n, dtype=torch.float32, device=dev)
                  if split > 1 else None)
            fn = _build.function("int4_gemm", "asq_int4_gemm_tc", _TC_ARGTYPES)
            rc = fn(*head, *scratch, *tail, split, _build.ptr(ws), _build.stream_ptr(x))
        else:
            fn = _build.function("int4_gemm", "asq_int4_gemm", _ARGTYPES)
            rc = fn(*head, *scratch, *tail, _build.stream_ptr(x))
    _build.check("int4_gemm", rc, "int4_matmul")
    int4_matmul.launches += 1
    if how == "tc":
        int4_matmul.tc_launches += 1
    if tok_scale is not None:
        int4_matmul.scale_launches += 1
    return out


# calls that launched K5 on the card, every route (plain CPU calls and the
# W4A16 route do not count), those of the tensor-core route alone, and those
# with a given per-token scale (a rank's planes of a row-parallel product)
int4_matmul.launches = 0
int4_matmul.tc_launches = 0
int4_matmul.scale_launches = 0
