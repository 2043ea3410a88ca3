"""fp8 GEMM with a fused scale epilogue: the port of
``autosmoothquant_tpu/kernels/gemm.py:fp8_matmul`` and of the TPU kernel it
streams through, ``kernels/fp8.py:_fp8_kernel``.

``fp8_matmul`` launches the CUDA kernels of ``csrc/fp8_gemm.cu`` (K4) for
CUDA tensors, at every M, and runs :func:`fp8_matmul_plain` for CPU tensors.
On the card it picks one of three routes from the shape alone
(:func:`route`): the GEMV for M <= 8; the tensor-core route (TMA, the fp8
tiles converted to f16 for ``wgmma`` with f32 accumulation, K split where
the output has too few tiles to fill the SMs) where TMA takes the operands
(K % 16 == 0, 16-byte aligned bases); CUDA-core tiles otherwise. K1 and K4
share the rule and the tile sizes (``gemm.route``, ``gemm.tc_split``). The
TPU gates its kernel to M <= 64 and an opt-in flag only because v5e has no
fp8 unit; Hopper has fp8 tensor cores. Weights are ``[N, K]`` fp8 (e4m3fn
or e5m2), K-contiguous, transposed once at load (``convert/from_jax.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .gemm import _as_vector, route, tc_split

_FORMATS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P)
_TC_ARGTYPES = (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P)


def fp8_matmul_plain(x_f8: torch.Tensor, w_t: torch.Tensor, row_scale=1.0,
                     col_scale=1.0, bias: Optional[torch.Tensor] = None, *,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version of K4: the true fp8 values multiplied with an
    f32 sum on the CPU (the JAX package's XLA path); on a CUDA tensor a
    float64 sum, so that a comparison with the kernel measures only the
    kernel's f32 summation (each fp8 product is exact in f32 and f64)."""
    m, n = x_f8.shape[0], w_t.shape[0]
    if x_f8.is_cuda:
        out = (x_f8.double() @ w_t.double().t()).float()
    else:
        out = x_f8.float() @ w_t.float().t()
    rs = _as_vector(row_scale, m, x_f8.device, "row_scale")
    if rs is not None:
        out = out * (rs.reshape(-1, 1) if rs.ndim else rs)
    cs = _as_vector(col_scale, n, x_f8.device, "col_scale")
    if cs is not None:
        out = out * (cs.reshape(1, -1) if cs.ndim else cs)
    if bias is not None:
        out = out + bias.float().reshape(1, n)
    return out.to(out_dtype)


def fp8_matmul(x_f8: torch.Tensor, w_t: torch.Tensor, row_scale=1.0,
               col_scale=1.0, bias: Optional[torch.Tensor] = None, *,
               out_dtype=torch.float32) -> torch.Tensor:
    """``(true(x_f8) @ true(w_t).T) * row_scale * col_scale + bias`` in
    ``out_dtype`` (f32 or bf16).

    x_f8: [M, K] and w_t: [N, K], one fp8 type (e4m3fn or e5m2); row_scale:
    f32 scalar, [M] or [M, 1] (per-tensor, static input or per-token
    scales); col_scale: f32 scalar, [N] or [1, N] (w_scale, or the
    per-column vector of fused sections); bias: f32 [N] or None."""
    if x_f8.dtype not in _FORMATS or w_t.dtype != x_f8.dtype:
        raise TypeError(f"fp8_matmul needs one fp8 type for both operands, "
                        f"got {x_f8.dtype} and {w_t.dtype}")
    if x_f8.ndim != 2 or w_t.ndim != 2 or x_f8.shape[1] != w_t.shape[1]:
        raise ValueError(f"shapes {tuple(x_f8.shape)} @ {tuple(w_t.shape)}.T "
                         "do not match ([M, K] @ [N, K].T)")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype={out_dtype}; expected f32 or bf16")
    if not x_f8.is_cuda:
        return fp8_matmul_plain(x_f8, w_t, row_scale, col_scale, bias,
                                out_dtype=out_dtype)
    m, k = x_f8.shape
    n = w_t.shape[0]
    dev = x_f8.device
    if w_t.device != dev:
        raise ValueError("x_f8 and w_t must be on one device")
    x_f8 = x_f8.contiguous()
    w_t = w_t.contiguous()
    rs = _as_vector(row_scale, m, dev, "row_scale")
    cs = _as_vector(col_scale, n, dev, "col_scale")
    rs = rs.contiguous() if rs is not None else None
    cs = cs.contiguous() if cs is not None else None
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous().reshape(n)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    args = (x_f8.data_ptr(), w_t.data_ptr(), _build.ptr(rs),
            int(rs is not None and rs.ndim), _build.ptr(cs),
            int(cs is not None and cs.ndim), _build.ptr(bias), out.data_ptr(),
            m, n, k, _FORMATS[x_f8.dtype], _OUT_KINDS[out_dtype])
    if route(m, k, x_f8, w_t) == "tc":
        split = tc_split(m, n, k)
        ws = (torch.empty(split * m * n, dtype=torch.float32, device=dev)
              if split > 1 else None)
        fn = _build.function("fp8_gemm", "asq_fp8_gemm_tc", _TC_ARGTYPES)
        rc = fn(*args, split, _build.ptr(ws), _build.stream_ptr(x_f8))
        _build.check("fp8_gemm", rc, "fp8_matmul")
        fp8_matmul.tc_launches += 1
    else:
        fn = _build.function("fp8_gemm", "asq_fp8_gemm", _ARGTYPES)
        rc = fn(*args, _build.stream_ptr(x_f8))
        _build.check("fp8_gemm", rc, "fp8_matmul")
    fp8_matmul.launches += 1
    return out


# launches of the CUDA kernels, every route (plain CPU calls do not count),
# and of the tensor-core route alone
fp8_matmul.launches = 0
fp8_matmul.tc_launches = 0
