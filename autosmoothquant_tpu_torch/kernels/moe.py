"""Mixtral's two kernels of its own: the routing (``csrc/moe_router.cu``) and
the expert-indexed GEMV (``csrc/asq_gemv.cuh``, through K1's and K4's
libraries).

``moe_route`` runs a layer's whole routing in one launch for CUDA tensors:
the router's f32 logits (JAX's ``jnp.dot`` at
``autosmoothquant_tpu/models/mixtral.py:383``, which the JAX package leaves
to XLA), the softmax, the top k and their renormalized weights; a row's bits
do not depend on the batch. ``expert_gemv`` runs, for the M <= 8 rows of a
decode step, the projection of every expert a row picked over all M rows in
one launch, reading only those experts' weights (the ids stay on the
device), and writes zeros for the rest; w1 and w3 share one launch. CPU
tensors take the plain versions, :func:`moe_route_plain` and
:func:`expert_gemv_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .fp8 import _FORMATS, fp8_matmul_plain
from .gemm import GEMV_MAX_M, gemv_blocks, int8_matmul_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, w, logits, top_w, top_idx, combine_rows, combine_w, rows, D, E, k, w_bf16,
# stream
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
# x, x_estride, w, ids, topk, E, row_scale, rs_estride, rs_stride, col_scale,
# cs_estride, cs_stride, out, w_b, col_scale_b, out_b, M, N, K, out_kind,
# blocks, slots, stream (fp8: fmt after K)
_EXPERT_ARGTYPES = (_P, _I, _P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                    _I, _I, _I, _I, _P)
_FP8_EXPERT_ARGTYPES = _EXPERT_ARGTYPES[:19] + (_I,) + _EXPERT_ARGTYPES[19:]

MAX_EXPERTS = 64    # both kernels: a 64-bit mask of experts, two experts a lane
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}


class Routing(NamedTuple):
    """A layer's routing of T rows: the top k experts of each row, descending
    (of equal probabilities the lower expert first), int64 [T, k], and their
    renormalized f32 weights; what a combine of the [E, T, N] expert outputs
    in ascending expert order reads: ``combine_rows`` (int64 [T, k]: e T + t
    of row t's i-th pick e in that order, a row of the outputs viewed [E T,
    N]) and ``combine_w`` (f32 [T, k]: its weight); and, where asked for,
    the f32 logits [T, E]."""

    top_w: torch.Tensor
    top_idx: torch.Tensor
    combine_rows: torch.Tensor
    combine_w: torch.Tensor
    logits: Optional[torch.Tensor] = None


def combine_operands(top_w: torch.Tensor, top_idx: torch.Tensor):
    """(combine_rows, combine_w) of a routing (:class:`Routing`), in torch
    ops."""
    t = top_idx.shape[0]
    order = torch.argsort(top_idx, dim=-1, stable=True)
    rows = top_idx.gather(1, order) * t + torch.arange(t, device=top_idx.device)[:, None]
    return rows, top_w.float().gather(1, order)


def router_logits_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 [T, E] = x @ w with both widened to f32 (JAX's ``jnp.dot`` of the
    f32 norm output and the f32 router)."""
    return x.float() @ w.float()


def moe_route_plain(x: torch.Tensor, w: torch.Tensor, k: int, *,
                    with_logits: bool = False) -> Routing:
    """The plain version of the routing: the router's f32 logits, a softmax
    over the experts, a stable descending sort (of equal probabilities the
    lower expert first, as ``lax.top_k`` takes them; a probability that
    underflows to 0 ties), its first k, renormalized."""
    logits = router_logits_plain(x, w)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return Routing(top_w, top_idx, *combine_operands(top_w, top_idx),
                   logits if with_logits else None)


def moe_route(x: torch.Tensor, w: torch.Tensor, k: int, *,
              with_logits: bool = False) -> Routing:
    """The routing of the norm output x [T, D] (f32 on the card) by the
    router w [D, E] (f32 or bf16), top ``k`` (0 < k <= E; k = E is the
    calibration's every-expert routing). One launch on the card, counted in
    ``launches``; ``with_logits`` also returns the logits it summed."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} @ w {tuple(w.shape)} do not match "
                         "([T, D] @ [D, E])")
    t, d = x.shape
    e = w.shape[1]
    if not 0 < k <= e:
        raise ValueError(f"k={k} for {e} experts")
    if not x.is_cuda:
        return moe_route_plain(x, w, k, with_logits=with_logits)
    if x.dtype != torch.float32 or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 and w f32 or bf16, got {x.dtype}/{w.dtype}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if e > MAX_EXPERTS:
        raise ValueError(f"the routing kernel takes at most {MAX_EXPERTS} experts, got {e}")
    x, w = x.contiguous(), w.contiguous()
    dev = x.device
    top_w = torch.empty((t, k), dtype=torch.float32, device=dev)
    top_idx = torch.empty((t, k), dtype=torch.int64, device=dev)
    rows = torch.empty((t, k), dtype=torch.int64, device=dev)
    rows_w = torch.empty((t, k), dtype=torch.float32, device=dev)
    logits = torch.empty((t, e), dtype=torch.float32, device=dev) if with_logits else None
    fn = _build.function("moe_router", "asq_moe_router", _ARGTYPES)
    rc = fn(x.data_ptr(), w.data_ptr(), _build.ptr(logits), top_w.data_ptr(),
            top_idx.data_ptr(), rows.data_ptr(), rows_w.data_ptr(), t, d, e, k,
            int(w.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check("moe_router", rc, "moe_route")
    moe_route.launches += 1
    return Routing(top_w, top_idx, rows, rows_w, logits)


# launches of the CUDA kernel (plain CPU calls do not count)
moe_route.launches = 0


def _row_scale(scale, e: int):
    """Expert e's row scale of :func:`expert_gemv`'s ``row_scale``."""
    if isinstance(scale, torch.Tensor) and scale.ndim == 3:
        return scale[e]
    return 1.0 if scale is None else scale


def expert_gemv_plain(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor, row_scale=1.0,
                      col_scale=None, *, out_dtype=torch.float32) -> torch.Tensor:
    """The plain version of :func:`expert_gemv`: ``int8_matmul_plain`` or
    ``fp8_matmul_plain`` of each picked expert, in ascending order, and
    zeros for the rest."""
    E, N = w.shape[:2]
    m = x.shape[-2]
    out = torch.zeros((E, m, N), dtype=out_dtype, device=x.device)
    mm = int8_matmul_plain if x.dtype == torch.int8 else fp8_matmul_plain
    for e in sorted({i for i in ids.reshape(-1).tolist() if 0 <= i < E}):
        cs = 1.0 if col_scale is None else col_scale[e]
        out[e] = mm(x[e] if x.ndim == 3 else x, w[e], _row_scale(row_scale, e), cs,
                    out_dtype=out_dtype)
    return out


def _scale_strides(scale, experts: int, inner: int, rows: bool, device):
    """(f32 tensor or None, expert stride, inner stride) of a row scale
    (``rows``: one for all experts, 0-d or ``inner`` rows; or [E, 1 or
    inner, 1], expert e's) or a column scale ([E] or [E, inner]) for the
    kernel."""
    if scale is None or (not isinstance(scale, torch.Tensor) and scale == 1.0):
        return None, 0, 0
    s = torch.as_tensor(scale, dtype=torch.float32, device=device).contiguous()
    if rows and s.ndim < 3 and s.numel() in (1, inner):
        return s, 0, int(s.numel() > 1)
    lead = s.shape[0] if s.ndim else 0
    if rows and s.ndim == 3 and lead == experts and s.shape[2] == 1 and s.shape[1] in (1, inner):
        return s, s.shape[1], int(s.shape[1] > 1)
    if not rows and 1 <= s.ndim <= 2 and lead == experts and s[0].numel() in (1, inner):
        return s, s[0].numel(), int(s[0].numel() > 1)
    raise ValueError(f"{'row' if rows else 'col'}_scale of shape {tuple(s.shape)} for "
                     f"{experts} experts of {inner} {'rows' if rows else 'columns'}")


def expert_gemv(x: torch.Tensor, w, ids: torch.Tensor, row_scale=1.0, col_scale=None, *,
                out_dtype=torch.float32):
    """For the M <= 8 rows of x and each expert e that ``ids`` names,
    ``out[e] = (x_e @ w[e].T) * row_scale_e * col_scale[e]``; zeros in
    ``out[e]`` of every expert no row picked. Returns [E, M, N] in
    ``out_dtype`` (f32 or bf16).

    x: int8 (K1) or fp8 (K4, w of the same type), [M, K] for every expert or
    [E, M, K] (expert e's own rows); w: [E, N, K]; ids: int64 [M, topk]
    (read on the device); row_scale: None, a number, 0-d, [M] or [M, 1] for
    every expert, or [E, 1, 1] / [E, M, 1] (expert e's); col_scale: None,
    [E] or [E, N]. ``w`` and ``col_scale`` may be pairs (w1 and w3: one
    shape, the same x and row scales, column scales of one shape), run in
    the same launch; the outputs are then a pair too. One launch on the card
    (the route of K1's and K4's decode GEMV over the picked experts),
    counted in ``launches``; K % 16 == 0 and 16-byte aligned x and w, as
    that route needs."""
    pair = isinstance(w, (tuple, list))
    ws = tuple(w) if pair else (w,)
    css = (tuple(col_scale) if col_scale is not None else (None, None)) if pair else (col_scale,)
    w0 = ws[0]
    if (len(ws) != len(css) or len(ws) > 2 or w0.ndim != 3 or x.ndim not in (2, 3)
            or x.shape[-1] != w0.shape[2] or (x.ndim == 3 and x.shape[0] != w0.shape[0])
            or any(v.shape != w0.shape for v in ws)):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {[tuple(v.shape) for v in ws]}: "
                         "expected x [M, K] or [E, M, K] and w [E, N, K] (or a pair of them)")
    fp8 = x.dtype in _FORMATS
    if (x.dtype != torch.int8 and not fp8) or any(v.dtype != x.dtype for v in ws):
        raise TypeError(f"expert_gemv needs int8 or one fp8 type, got {x.dtype}/{w0.dtype}")
    if ids.ndim != 2 or ids.dtype != torch.int64 or ids.shape[0] != x.shape[-2]:
        raise ValueError(f"ids must be int64 [M, topk], got {ids.dtype} {tuple(ids.shape)}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype={out_dtype}; expected f32 or bf16")
    if not x.is_cuda:
        outs = tuple(expert_gemv_plain(x, v, ids, row_scale, c, out_dtype=out_dtype)
                     for v, c in zip(ws, css))
        return outs if pair else outs[0]
    E, N, K = w0.shape
    m, topk = ids.shape
    if not 1 <= m <= GEMV_MAX_M or E > MAX_EXPERTS:
        raise ValueError(f"expert_gemv takes 1-{GEMV_MAX_M} rows and at most {MAX_EXPERTS} "
                         f"experts, got {m} and {E}")
    if any(v.device != x.device for v in ws) or ids.device != x.device:
        raise ValueError("x, w and ids must be on one device")
    x, ids = x.contiguous(), ids.contiguous()
    ws = tuple(v.contiguous() for v in ws)
    rs, rs_e, rs_m = _scale_strides(row_scale, E, m, True, x.device)
    cols = [_scale_strides(c, E, N, False, x.device) for c in css]
    if any(c[1:] != cols[0][1:] for c in cols):
        raise ValueError("a pair's column scales must have one shape")
    outs = tuple(torch.empty((E, m, N), dtype=out_dtype, device=x.device) for _ in ws)
    second = (ws[1], cols[1][0], outs[1]) if pair else (None, None, None)
    args = [x.data_ptr(), m * K if x.ndim == 3 else 0, ws[0].data_ptr(), ids.data_ptr(), topk, E,
            _build.ptr(rs), rs_e, rs_m, _build.ptr(cols[0][0]), cols[0][1], cols[0][2],
            outs[0].data_ptr(), *(_build.ptr(t) for t in second), m, N, K]
    if fp8:
        fn = _build.function("fp8_gemm", "asq_fp8_expert_gemv", _FP8_EXPERT_ARGTYPES)
        args.append(_FORMATS[x.dtype])
        lib = "fp8_gemm"
    else:
        fn = _build.function("int8_gemm", "asq_int8_expert_gemv", _EXPERT_ARGTYPES)
        lib = "int8_gemm"
    rc = fn(*args, _OUT_KINDS[out_dtype], gemv_blocks(N), min(E, m * topk),
            _build.stream_ptr(x))
    _build.check(lib, rc, "expert_gemv")
    expert_gemv.launches += 1
    return outs if pair else outs[0]


# launches of the CUDA kernel, K1's and K4's alike (plain CPU calls do not
# count)
expert_gemv.launches = 0
