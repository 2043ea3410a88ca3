"""Flash attention for prefill: the port of
``autosmoothquant_tpu/kernels/attention.py`` (``flash_attention`` and
``flash_attention_banded``).

Both entry points launch the CUDA kernel ``csrc/flash_attn.cu`` (K3) for
CUDA tensors, and keep separate launch counts so a run shows which prefill
route it took; CPU tensors run the plain versions. K3 computes bf16 on the
tensor cores (``mma.sync``, P rounded to bf16 before the value product) and
f32 on the CUDA cores (tensor cores would round f32 to TF32). Layout as in
the JAX package: q [B, T, Hq, D], k/v [B, S, Hkv, D], GQA with Hq % Hkv == 0.

A query row with no valid key is written as 0, as the TPU kernels write it
(the eager ``attend`` averages such rows instead; callers compare valid rows).

K3 is built for compute widths of 64 and 128 and reads any D <= 128 (OPT-2.7B's
80) as it lies, its shared-memory tiles zero past D. Its bf16 route copies
16 bytes at a time, so a D that is not a multiple of 8 is zero-padded to one
first (:func:`_pad_head_dim`) and the output cut back; D > 128 raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _I, _P)
_MAX_HEAD_DIM = 128


def _band_attention_plain(q, k, v, pos, starts, sm_scale, causal):
    """Masked softmax attention, f32, zero for rows with no valid key."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * sm_scale
    if causal:
        rows = torch.arange(t, device=q.device).reshape(1, t, 1)
        cols = torch.arange(s, device=q.device).reshape(1, 1, s)
        keep = ((cols <= rows + pos.reshape(b, 1, 1))
                & (cols >= starts.reshape(b, 1, 1)))           # [B, T, S]
        scores = scores.masked_fill(~keep[:, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", p / torch.where(l == 0, 1.0, l),
                       v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def _check(q, k, v):
    b, t, hq, d = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")


def _pad_head_dim(q, k, v):
    """q, k, v zero-padded along D to a multiple of 8 (unchanged where D is
    one). Exact: a padded dim adds 0 to every score and its output columns
    are cut off; the caller's sm_scale stays (it is never recomputed from
    the padded D)."""
    d = q.shape[-1]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernel's {_MAX_HEAD_DIM}")
    dp = -(-d // 8) * 8
    if dp == d:
        return q, k, v
    return tuple(F.pad(t, (0, dp - d)) for t in (q, k, v))


def _launch(wrapper, q, k, v, pos, starts, sm_scale, causal):
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q/k/v must share f32 or bf16: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    d_true = q.shape[3]
    q, k, v = _pad_head_dim(q, k, v)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    # contiguous, with 16-byte aligned bases (the bf16 route's cp.async
    # copies 16 bytes at a time); a fresh allocation is aligned
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.function("flash_attn", "asq_flash_attention", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(pos), _build.ptr(starts), b, t, s, hq, hkv, d,
            float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q))
    _build.check("flash_attn", rc, wrapper.__name__)
    wrapper.launches += 1
    return out if d == d_true else out[..., :d_true].contiguous()


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool = True):
    zeros = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return _band_attention_plain(q, k, v, zeros, zeros, sm_scale, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True) -> torch.Tensor:
    """Causal (or full) attention of q [B, T, Hq, D] over k/v [B, S, Hkv, D]
    with S = T. Returns [B, T, Hq, D] in q.dtype."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, sm_scale=sm_scale, causal=causal)
    return _launch(flash_attention, q, k, v, None, None, sm_scale, causal)


def _row_vector(x, b, device):
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.reshape(-1).expand(b).contiguous()


def flash_attention_banded_plain(q, k, v, pos, starts=None, *,
                                 sm_scale: float):
    b = q.shape[0]
    pos = _row_vector(pos, b, q.device)
    starts = _row_vector(0 if starts is None else starts, b, q.device)
    return _band_attention_plain(q, k, v, pos, starts, sm_scale, True)


def flash_attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos, starts: Optional[torch.Tensor] = None, *,
                           sm_scale: float) -> torch.Tensor:
    """Chunked-prefill attention: q [B, Tq, Hq, D] are a chunk's queries at
    cache slots [pos_b, pos_b + Tq); k/v [B, S, Hkv, D] are full cache rows.
    Query i attends columns [starts_b, pos_b + i]. pos/starts: int scalars or
    int32 [B] (starts defaults to 0)."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_banded_plain(q, k, v, pos, starts,
                                            sm_scale=sm_scale)
    b = q.shape[0]
    pos = _row_vector(pos, b, q.device)
    starts = _row_vector(0 if starts is None else starts, b, q.device)
    return _launch(flash_attention_banded, q, k, v, pos, starts, sm_scale,
                   True)


# launches of the CUDA kernel per entry point (plain CPU calls do not count)
flash_attention.launches = 0
flash_attention_banded.launches = 0
