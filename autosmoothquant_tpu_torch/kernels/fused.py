"""Fused residual-add + norm + int8 quantize: the port of
``autosmoothquant_tpu/kernels/fused.py`` (``fused_add_rmsnorm_quant`` for the
Llama family, ``fused_add_layernorm_quant`` for OPT), and the port's own
RMSNorm (``rmsnorm_quant``: every RMSNorm of the Llama, Gemma, Baichuan and
Mixtral forwards that K2 does not run, the final norm included, but those
before int4 projections, with the residual add before it folded in and its
output int8, f32 or bf16 as its consumer reads it; the JAX package leaves
these ops to XLA).

CUDA tensors launch ``csrc/add_rmsnorm_quant.cu`` (K2) or
``csrc/add_layernorm_quant.cu`` (K6), each on the route :func:`norm_route`
gives, or ``csrc/rmsnorm_quant.cu``; CPU tensors run the ``*_plain``
versions.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.math import recip_sqrt_rn, rsqrt_rn
from . import _build

_P = ctypes.c_void_p
# the widest row the kernels take: the rows routes keep one f32 row in shared
# memory, the vector routes up to 3 chunks of 8 in each of 512 threads
_MAX_D = 12 * 1024
# h, x, the norm vectors (gamma; gamma and beta), out_h, out_q, rows, D, eps,
# is_bf16, stream
_TAIL = (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P)
_ARGTYPES = {"add_rmsnorm_quant": (_P,) * 5 + _TAIL,
             "add_layernorm_quant": (_P,) * 6 + _TAIL}
# each library's entry point by its route (:func:`norm_route`)
_ENTRIES = {"add_rmsnorm_quant": {"vector": "asq_add_rmsnorm_quant_vec",
                                  "rows": "asq_add_rmsnorm_quant"},
            "add_layernorm_quant": {"vector": "asq_add_layernorm_quant_vec",
                                    "rows": "asq_add_layernorm_quant"}}


def norm_route(d: int, *tensors: torch.Tensor) -> str:
    """K2's and K6's route for rows of ``d`` elements: "vector" (the row in
    registers, 16-byte loads and stores: D % 8 == 0, D <= 12288 and every
    operand 16-byte aligned) or "rows" (the row in shared memory, any D)."""
    if d % 8 == 0 and d <= _MAX_D and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "vector"
    return "rows"


def fused_add_rmsnorm_quant_plain(h: torch.Tensor, x: torch.Tensor,
                                  gamma: torch.Tensor, *, eps: float = 1e-6):
    """Returns (h + x in h's dtype, int8 of round(rmsnorm(h + x) * gamma))."""
    s = h.float() + x.float()
    var = (s * s).mean(dim=-1, keepdim=True)
    y = s * recip_sqrt_rn(var + eps) * gamma.float()
    q = torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    return s.to(h.dtype), q


def _check(h, x, norm_vectors):
    """The checks both wrappers share; raises on what the kernels refuse.
    Returns True for CUDA tensors (launch), False for CPU ones (plain)."""
    d = h.shape[-1] if h.ndim == 2 else None
    if (h.shape != x.shape or h.ndim != 2
            or any(v.shape != (d,) for v in norm_vectors)):
        raise ValueError(f"shapes h {tuple(h.shape)}, x {tuple(x.shape)}, "
                         f"norm vectors {[tuple(v.shape) for v in norm_vectors]}")
    if not h.is_cuda:
        return False
    if h.dtype not in (torch.float32, torch.bfloat16) or x.dtype != h.dtype:
        raise TypeError(f"h/x must share f32 or bf16, got {h.dtype}/{x.dtype}")
    if any(v.dtype != torch.float32 for v in norm_vectors):
        raise TypeError("gamma/beta must be f32 (norm weights are kept in f32)")
    if d > _MAX_D:
        raise ValueError(f"D={d} exceeds the kernel's {_MAX_D}")
    return True


def _launch(wrapper, lib, h, x, vecs, eps):
    """Launch ``csrc/<lib>.cu`` on contiguous h, x and norm vectors, on the
    route :func:`norm_route` gives for them and the outputs."""
    t, d = h.shape
    out_h = torch.empty_like(h)
    out_q = torch.empty((t, d), dtype=torch.int8, device=h.device)
    how = norm_route(d, h, x, *vecs, out_h, out_q)
    fn = _build.function(lib, _ENTRIES[lib][how], _ARGTYPES[lib])
    rc = fn(h.data_ptr(), x.data_ptr(), *(v.data_ptr() for v in vecs),
            out_h.data_ptr(), out_q.data_ptr(), t, d, float(eps),
            int(h.dtype == torch.bfloat16), _build.stream_ptr(h))
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    if how == "vector":
        wrapper.vec_launches += 1
    return out_h, out_q


def fused_add_rmsnorm_quant(h: torch.Tensor, x: torch.Tensor,
                            gamma: torch.Tensor, *, eps: float = 1e-6):
    """h, x: [T, D] (f32 or bf16); gamma: [D] with the per-tensor input scale
    folded in. Returns (h + x in h.dtype, int8 [T, D])."""
    if not _check(h, x, (gamma,)):
        return fused_add_rmsnorm_quant_plain(h, x, gamma, eps=eps)
    return _launch(fused_add_rmsnorm_quant, "add_rmsnorm_quant", h.contiguous(),
                   x.contiguous(), (gamma.contiguous(),), eps)


def fused_add_layernorm_quant_plain(h: torch.Tensor, x: torch.Tensor,
                                    gamma: torch.Tensor, beta: torch.Tensor,
                                    *, eps: float = 1e-5):
    """Returns (h + x in h's dtype, int8 of round(layernorm(h + x) * gamma +
    beta)); the variance is two-pass, the mean of the centred squares."""
    s = h.float() + x.float()
    c = s - s.mean(dim=-1, keepdim=True)
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * rsqrt_rn(var + eps) * gamma.float() + beta.float()
    q = torch.clamp(torch.round(y), -128, 127).to(torch.int8)
    return s.to(h.dtype), q


def fused_add_layernorm_quant(h: torch.Tensor, x: torch.Tensor,
                              gamma: torch.Tensor, beta: torch.Tensor, *,
                              eps: float = 1e-5):
    """h, x: [T, D] (f32 or bf16); gamma, beta: f32 [D], both with the
    per-tensor input scale folded in (OPT's pre-LN block). Returns (h + x in
    h.dtype, int8 [T, D])."""
    if not _check(h, x, (gamma, beta)):
        return fused_add_layernorm_quant_plain(h, x, gamma, beta, eps=eps)
    h, x, gamma, beta = (v.contiguous() for v in (h, x, gamma, beta))
    return _launch(fused_add_layernorm_quant, "add_layernorm_quant", h, x,
                   (gamma, beta), eps)


# x, r, gamma, s, out, rows, D, eps, is_bf16, out_kind, stream
_RMS_ARGTYPES = (_P,) * 5 + (ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, _P)
# rmsnorm_quant's outputs by csrc/asq_common.cuh:AsqOutKind
_RMS_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 (JAX ``models/common.py:rms_norm``): x * rsqrt(mean(x^2)
    + eps) * weight, torch's mean. For a per-tensor int8 consumer ``weight``
    already holds the folded 1/input_scale, so the output is in int8 units."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * recip_sqrt_rn(var + eps) * weight.float()


def _rms_out_kind(dt: torch.dtype) -> int:
    """rmsnorm_quant's output dtype as ``csrc/asq_common.cuh:AsqOutKind``."""
    if dt not in _RMS_OUT_KINDS:
        raise TypeError(f"rmsnorm_quant writes int8, f32 or bf16, not {dt}")
    return _RMS_OUT_KINDS[dt]


def rmsnorm_quant_plain(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
                        out_dtype: torch.dtype = torch.int8, residual=None):
    """The ops it fuses, as JAX and the port ran them before: with
    ``residual``, s = x + residual in x's dtype (the f32 sum rounded once, a
    torch add's bits); then :func:`rms_norm` of s (or x), then
    ``quantize_act_prescaled`` (int8 of round-half-even, clamped) or the
    cast to ``out_dtype``. Returns the output, or with ``residual`` (s,
    output). The kernel sums the squares in an order of its own (set by D
    alone), so its int8 may sit one step from this where y lies within a
    last bit of a rounding boundary."""
    _rms_out_kind(out_dtype)
    if residual is not None:
        x = (x.float() + residual.float()).to(x.dtype)
    y = rms_norm(x, gamma, eps)
    out = (torch.clamp(torch.round(y), -128, 127).to(torch.int8) if out_dtype == torch.int8
           else y.to(out_dtype))
    return out if residual is None else (x, out)


def rmsnorm_quant(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
                  out_dtype: torch.dtype = torch.int8, residual=None):
    """x: [T, D] (f32 or bf16); gamma: f32 [D] (with the per-tensor input
    scale folded in where the output feeds an int8 GEMM); ``residual``: None,
    or [T, D] in x's dtype, added first (s = x + residual, rounded to x's
    dtype, and the norm is of s). The output: int8 [T, D] of
    round(rmsnorm * gamma) (``out_dtype`` int8), else rmsnorm * gamma in
    ``out_dtype`` (f32 or bf16).
    Returns the output, or with ``residual`` (s, output). A row's bits do
    not depend on T. CUDA tensors launch ``csrc/rmsnorm_quant.cu`` (D % 8 ==
    0, D <= 12288; anything else raises); counted in ``launches``, the
    unquantized outputs in ``norm_launches`` too and the residual mode in
    ``res_launches`` too."""
    if x.ndim != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"shapes x {tuple(x.shape)}, gamma {tuple(gamma.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} is not x's "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return rmsnorm_quant_plain(x, gamma, eps=eps, out_dtype=out_dtype, residual=residual)
    t, d = x.shape
    kind = _rms_out_kind(out_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16) or gamma.dtype != torch.float32:
        raise TypeError(f"x must be f32 or bf16 and gamma f32, got {x.dtype}/{gamma.dtype}")
    if d % 8 or d > _MAX_D:
        raise ValueError(f"D={d}: the kernel takes D % 8 == 0 up to {_MAX_D}")
    # contiguous, with 16-byte aligned bases (a fresh allocation is aligned)
    x, gamma, residual = (None if v is None else v.contiguous() if v.data_ptr() % 16 == 0
                          else v.clone(memory_format=torch.contiguous_format)
                          for v in (x, gamma, residual))
    out = torch.empty((t, d), dtype=out_dtype, device=x.device)
    s = None if residual is None else torch.empty_like(x)
    fn = _build.function("rmsnorm_quant", "asq_rmsnorm_quant", _RMS_ARGTYPES)
    rc = fn(x.data_ptr(), None if residual is None else residual.data_ptr(), gamma.data_ptr(),
            None if s is None else s.data_ptr(), out.data_ptr(), t, d, float(eps),
            int(x.dtype == torch.bfloat16), kind, _build.stream_ptr(x))
    _build.check("rmsnorm_quant", rc, "rmsnorm_quant")
    rmsnorm_quant.launches += 1
    if out_dtype != torch.int8:
        rmsnorm_quant.norm_launches += 1
    if s is None:
        return out
    rmsnorm_quant.res_launches += 1
    return s, out


# launches of the CUDA kernels (plain CPU calls do not count), and of the
# vector route alone (counted in launches too)
for _wrapper in (fused_add_rmsnorm_quant, fused_add_layernorm_quant):
    _wrapper.launches = 0
    _wrapper.vec_launches = 0
rmsnorm_quant.launches = 0
rmsnorm_quant.norm_launches = 0
rmsnorm_quant.res_launches = 0
