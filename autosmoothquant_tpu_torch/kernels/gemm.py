"""int8 GEMM with fused dequant epilogue: the port of
``autosmoothquant_tpu/kernels/gemm.py`` (``int8_matmul``).

``int8_matmul`` launches the CUDA kernels of ``csrc/int8_gemm.cu`` (K1) for
CUDA tensors and runs :func:`int8_matmul_plain` for CPU tensors. On the card
it picks one of four routes from the shape alone (:func:`route`). Where
K % 16 == 0 and the bases are 16-byte aligned: the GEMV for M <= 8
(``csrc/asq_gemv.cuh``: a cp.async ring, x read once a block, int8
``mma.sync`` with the weights as A; its grid from :func:`gemv_blocks`), and
for M > 8 the tensor-core route (TMA and int8 ``wgmma`` with int32
accumulation, K split where the output has too few tiles to fill the SMs).
Otherwise a ragged GEMV (M <= 8) or CUDA-core tiles. Weights are
``[N, K]`` int8, K-contiguous (``nn.Linear``'s layout): the JAX package's
``[K, N]`` leaves are transposed once when they are loaded
(``convert/from_jax.py``), never per call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

INT8_MIN = -128.0
INT8_MAX = 127.0

_ACTS = {None: 0, "relu": 1, "silu": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P)
_TC_ARGTYPES = (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P)
_GEMV_ARGTYPES = (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P)

GEMV_MAX_M = 8
GEMV_ROWS = 16   # weight rows (output columns) a GEMV block owns
_TC_BM = 64      # rows a consumer warpgroup covers (a block: 64, or 128 for M > 64)
_TC_BN = 64      # columns a block covers
_TC_BK = 128     # K bytes a pipeline stage holds
_SMS = 132       # streaming multiprocessors of an H100 SXM


def route(m: int, k: int, *tensors: torch.Tensor) -> str:
    """The route of K1 and of K4 (``fp8.py``) for an [m, k] @ [n, k].T
    product. Where K % 16 == 0 and every base is 16-byte aligned (16-byte
    copies of a row, and TMA's tiles, need both): "gemv" for M <= 8, "tc"
    (the tensor-core route) above. Otherwise "gemv_ragged" (M <= 8) or
    "tiles" (CUDA-core tiles)."""
    aligned = k % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    if m <= GEMV_MAX_M:
        return "gemv" if aligned else "gemv_ragged"
    return "tc" if aligned else "tiles"


def gemv_blocks(n: int) -> int:
    """The grid of the GEMV of K1 and K4 (``csrc/asq_gemv.cuh``) for N
    weight rows: one block per 16 rows, so every column is one block's.
    Its 8 warps split K and its shared memory (a 48 KB ring of 4 steps,
    never all of x) does not depend on the shape: four blocks an SM."""
    return -(-n // GEMV_ROWS)


def tc_split(m: int, n: int, k: int) -> int:
    """K splits of K1's and K4's tensor-core routes, and of K5's (``int4.py``,
    with k the packed bytes K'/2): enough (m, n) blocks x splits to start one
    block on every SM, no split empty. Blocks are 64 x 64 for M <= 64 and
    128 x 64 above (one weight tile read once for all of M <= 128), and a K
    stage is 128 bytes."""
    bm = _TC_BM if m <= _TC_BM else 2 * _TC_BM
    tiles = -(-m // bm) * -(-n // _TC_BN)
    k_tiles = -(-k // _TC_BK)
    split = max(1, min(k_tiles, -(-_SMS // tiles)))
    per = -(-k_tiles // split)
    return -(-k_tiles // per)


def _as_vector(scale, n: int, device, name: str):
    """A scalar or [n]-shaped f32 scale as a 0-d or [n] f32 tensor; None
    for the Python number 1 (the kernel's null scale)."""
    if not isinstance(scale, torch.Tensor) and scale == 1.0:
        return None
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.numel() not in (1, n):
        raise ValueError(f"{name} has {s.numel()} values; expected 1 or {n}")
    return s.reshape(()) if s.numel() == 1 else s.reshape(n)


def int8_matmul_plain(x_q: torch.Tensor, w_t: torch.Tensor, row_scale=1.0,
                      col_scale=1.0, bias: Optional[torch.Tensor] = None, *,
                      activation: Optional[str] = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version of K1, exact in the accumulator: on the CPU
    ``torch._int_mm`` (int8 x int8 -> int32; about 20x torch's int32 matmul
    there, the same bits), or the int32 matmul where K < 8 (``_int_mm`` gave
    zeros at K = 1); on a CUDA tensor (where torch has no int32 matmul for
    every shape) a float64 one, exact because |acc| <= 128 * 127 * K stays far
    below 2**53."""
    if x_q.is_cuda:
        acc = (x_q.double() @ w_t.double().t()).to(torch.int32)
    elif x_q.shape[1] >= 8:
        acc = torch._int_mm(x_q.contiguous(), w_t.contiguous().t())
    else:
        acc = x_q.to(torch.int32) @ w_t.to(torch.int32).t()
    if out_dtype == torch.int32:
        return acc
    return epilogue(acc, row_scale, col_scale, bias, activation=activation,
                    out_dtype=out_dtype)


def epilogue(acc: torch.Tensor, row_scale=1.0, col_scale=1.0,
             bias: Optional[torch.Tensor] = None, *, activation: Optional[str] = None,
             out_dtype=torch.float32) -> torch.Tensor:
    """K1's epilogue of an int32 accumulator [M, N] in torch ops, in the
    kernel's order: ``act((acc * row_scale) * col_scale + bias)``, each op
    rounded on its own (no fused multiply-add), so an exact accumulator gives
    the kernel's bits. A row-parallel projection runs it once on the int32
    sum of the ranks' partials (``models/common.py:row_linear``)."""
    m, n = acc.shape
    out = acc.float()
    rs = _as_vector(row_scale, m, acc.device, "row_scale")
    if rs is not None:
        out = out * (rs.reshape(-1, 1) if rs.ndim else rs)
    cs = _as_vector(col_scale, n, acc.device, "col_scale")
    if cs is not None:
        out = out * (cs.reshape(1, -1) if cs.ndim else cs)
    if bias is not None:
        out = out + bias.float().reshape(1, n)
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    elif activation == "silu":
        out = out * torch.sigmoid(out)
    if out_dtype == torch.int8:
        out = torch.clamp(torch.round(out), INT8_MIN, INT8_MAX)
    return out.to(out_dtype)


def int8_matmul(x_q: torch.Tensor, w_t: torch.Tensor, row_scale=1.0,
                col_scale=1.0, bias: Optional[torch.Tensor] = None, *,
                activation: Optional[str] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """``act((x_q @ w_t.T) * row_scale * col_scale + bias)`` in ``out_dtype``.

    x_q: int8 [M, K]; w_t: int8 [N, K]; row_scale: f32 scalar, [M] or [M, 1]
    (per-token activation scales); col_scale: f32 scalar, [N] or [1, N]
    (weight / fused-section scales); bias: f32 [N] or None; activation: None,
    "relu" or "silu"; out_dtype int8 rounds half to even and clamps;
    out_dtype int32 returns the exact accumulator itself, and then takes no
    scale, bias or activation (a row-parallel partial: :func:`epilogue`
    runs once on the ranks' sum)."""
    if x_q.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError(f"int8_matmul needs int8 operands, got {x_q.dtype} "
                        f"and {w_t.dtype}")
    if x_q.ndim != 2 or w_t.ndim != 2 or x_q.shape[1] != w_t.shape[1]:
        raise ValueError(f"shapes {tuple(x_q.shape)} @ {tuple(w_t.shape)}.T "
                         "do not match ([M, K] @ [N, K].T)")
    if activation not in _ACTS or out_dtype not in _OUT_KINDS:
        raise ValueError(f"activation={activation!r} out_dtype={out_dtype}")
    if out_dtype == torch.int32 and (
            bias is not None or activation is not None
            or any(isinstance(s, torch.Tensor) or s != 1.0 for s in (row_scale, col_scale))):
        raise ValueError("out_dtype int32 is the bare accumulator: no scale, bias or "
                         "activation")
    if not x_q.is_cuda:
        return int8_matmul_plain(x_q, w_t, row_scale, col_scale, bias,
                                 activation=activation, out_dtype=out_dtype)
    m, k = x_q.shape
    n = w_t.shape[0]
    dev = x_q.device
    if w_t.device != dev:
        raise ValueError("x_q and w_t must be on one device")
    x_q = x_q.contiguous()
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
    args = (x_q.data_ptr(), w_t.data_ptr(), _build.ptr(rs),
            int(rs is not None and rs.ndim), _build.ptr(cs),
            int(cs is not None and cs.ndim), _build.ptr(bias), out.data_ptr(),
            m, n, k, _ACTS[activation], _OUT_KINDS[out_dtype])
    how = route(m, k, x_q, w_t)
    if out_dtype == torch.int32:
        int8_matmul.i32_launches += 1
    if how == "gemv":
        fn = _build.function("int8_gemm", "asq_int8_gemv", _GEMV_ARGTYPES)
        rc = fn(*args, gemv_blocks(n), _build.stream_ptr(x_q))
        _build.check("int8_gemm", rc, "int8_matmul")
        int8_matmul.gemv_launches += 1
    elif how == "tc":
        split = tc_split(m, n, k)
        ws = (torch.empty(split * m * n, dtype=torch.int32, device=dev)
              if split > 1 else None)
        fn = _build.function("int8_gemm", "asq_int8_gemm_tc", _TC_ARGTYPES)
        rc = fn(*args, split, _build.ptr(ws), _build.stream_ptr(x_q))
        _build.check("int8_gemm", rc, "int8_matmul")
        int8_matmul.tc_launches += 1
    else:
        fn = _build.function("int8_gemm", "asq_int8_gemm", _ARGTYPES)
        rc = fn(*args, _build.stream_ptr(x_q))
        _build.check("int8_gemm", rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


# launches of the CUDA kernels, every route (plain CPU calls do not count),
# of the "gemv" and tensor-core routes alone, and of the int32 output (a
# row-parallel partial)
int8_matmul.launches = 0
int8_matmul.i32_launches = 0
int8_matmul.gemv_launches = 0
int8_matmul.tc_launches = 0
