"""Attention kernels: flash attention for prefill, the port of
``autosmoothquant_tpu/kernels/attention.py`` (``flash_attention`` and
``flash_attention_banded``), and the port's own decode attention
(``decode_attention``, one query token a row over a contiguous cache or
block-paged pages; the JAX package runs decode attention as XLA ops).

Both entry points launch the CUDA kernel ``csrc/flash_attn.cu`` (K3) for
CUDA tensors, and keep separate launch counts so a run shows which prefill
route it took; CPU tensors run the plain versions. K3 computes bf16 on the
tensor cores (``mma.sync``, P rounded to bf16 before the value product) and
f32 on the CUDA cores (tensor cores would round f32 to TF32). Layout as in
the JAX package: q [B, T, Hq, D], k/v [B, S, Hkv, D], GQA with Hq % Hkv == 0.

A query row with no valid key is written as 0, as the TPU kernels write it
(the eager ``attend`` averages such rows instead; callers compare valid rows).

K3 is built for compute widths of 64, 128 and 256 and reads any D <= 256
(OPT-2.7B's 80, Gemma's 256) as it lies, its shared-memory tiles zero past D.
Its bf16 route copies 16 bytes at a time, so a D that is not a multiple of 8
is zero-padded to one first (:func:`_pad_head_dim`) and the output cut back;
D > 256 raises. Decode attention takes D % 8 == 0 up to 256.

ALiBi (Baichuan-13B): every entry point takes optional ``alibi_slopes``, f32
[Hq], and adds m_h * (key column) to each score after the scale and before
the mask, as the JAX package's ``alibi_bias`` (m_h * key slot) and
``paged_attend(alibi_slopes=...)`` (m_h * key position) add it. The key
column is the slot of the cache row (prefill: the position; paged: the
logical position j * bs + i).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _I, _P)
_MAX_HEAD_DIM = 256


def alibi_bias(slopes: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The ALiBi term m_h * column, f32 [Hq, n_cols]: the product of the
    slope and the column as f32, as the JAX package forms it."""
    col = torch.arange(n_cols, device=slopes.device).float()
    return slopes.float()[:, None] * col[None, :]


def _check_slopes(slopes, hq: int):
    if slopes is None:
        return None
    if slopes.shape != (hq,):
        raise ValueError(f"alibi_slopes {tuple(slopes.shape)}: f32 [Hq={hq}]")
    return slopes.float().contiguous()


def _band_attention_plain(q, k, v, pos, starts, sm_scale, causal, slopes=None):
    """Masked softmax attention, f32, zero for rows with no valid key."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * sm_scale
    if slopes is not None:
        scores = scores + alibi_bias(slopes, s).reshape(1, hkv, g, 1, s)
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


def _launch(wrapper, q, k, v, pos, starts, sm_scale, causal, slopes):
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
            _build.ptr(pos), _build.ptr(starts), _build.ptr(slopes), b, t, s, hq, hkv, d,
            float(sm_scale), int(causal), int(q.dtype == torch.bfloat16),
            _build.stream_ptr(q))
    _build.check("flash_attn", rc, wrapper.__name__)
    wrapper.launches += 1
    return out if d == d_true else out[..., :d_true].contiguous()


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool = True,
                          alibi_slopes: Optional[torch.Tensor] = None):
    zeros = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return _band_attention_plain(q, k, v, zeros, zeros, sm_scale, causal, alibi_slopes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, causal: bool = True,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal (or full) attention of q [B, T, Hq, D] over k/v [B, S, Hkv, D]
    with S = T, with the ALiBi term where ``alibi_slopes`` (f32 [Hq]) is
    given. Returns [B, T, Hq, D] in q.dtype."""
    _check(q, k, v)
    slopes = _check_slopes(alibi_slopes, q.shape[2])
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, sm_scale=sm_scale, causal=causal,
                                     alibi_slopes=slopes)
    return _launch(flash_attention, q, k, v, None, None, sm_scale, causal, slopes)


def _row_vector(x, b, device):
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.reshape(-1).expand(b).contiguous()


def flash_attention_banded_plain(q, k, v, pos, starts=None, *,
                                 sm_scale: float,
                                 alibi_slopes: Optional[torch.Tensor] = None):
    b = q.shape[0]
    pos = _row_vector(pos, b, q.device)
    starts = _row_vector(0 if starts is None else starts, b, q.device)
    return _band_attention_plain(q, k, v, pos, starts, sm_scale, True, alibi_slopes)


def flash_attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos, starts: Optional[torch.Tensor] = None, *,
                           sm_scale: float,
                           alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-prefill attention: q [B, Tq, Hq, D] are a chunk's queries at
    cache slots [pos_b, pos_b + Tq); k/v [B, S, Hkv, D] are full cache rows.
    Query i attends columns [starts_b, pos_b + i]. pos/starts: int scalars or
    int32 [B] (starts defaults to 0). ``alibi_slopes``: f32 [Hq] or None."""
    _check(q, k, v)
    slopes = _check_slopes(alibi_slopes, q.shape[2])
    if not q.is_cuda:
        return flash_attention_banded_plain(q, k, v, pos, starts,
                                            sm_scale=sm_scale, alibi_slopes=slopes)
    b = q.shape[0]
    pos = _row_vector(pos, b, q.device)
    starts = _row_vector(0 if starts is None else starts, b, q.device)
    return _launch(flash_attention_banded, q, k, v, pos, starts, sm_scale,
                   True, slopes)


# launches of the CUDA kernel per entry point (plain CPU calls do not count)
flash_attention.launches = 0
flash_attention_banded.launches = 0


# ---------------------------------------------------------------------------
# decode attention (csrc/decode_attn.cu)
# ---------------------------------------------------------------------------

# q, k, v, k_scale, v_scale, table, pos, kv_valid, slopes, out, then B, Hq,
# Hkv, D, kv_rows, table_cols, pos_stride, valid_stride, n_cols, window,
# scale, kv_kind, q_bf16, round_p, recompute, stream
_DECODE_ARGTYPES = (_P,) * 10 + (_I,) * 10 + (ctypes.c_float, _I, _I, _I, _I, _P)
# G, D, n_cols, kv_kind, q_bf16
_DECODE_KEEPS_ARGTYPES = (_I,) * 5
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def decode_keeps_scores(g: int, d: int, n_cols: int, kv_dtype: torch.dtype,
                        q_dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether ``csrc/decode_attn.cu`` keeps a launch's score rows in shared
    memory (else its later passes recompute them, with the same bits), for
    G query heads a kv head, head dim D, ``n_cols`` columns and the cache's
    and q's dtypes: the kernel's own choice, by shape alone. Needs the card
    (the kernel's shared memory is granted on first use)."""
    fn = _build.function("decode_attn", "asq_decode_keeps_scores", _DECODE_KEEPS_ARGTYPES)
    rc = fn(g, d, n_cols, _KV_KINDS[kv_dtype], int(q_dtype == torch.bfloat16))
    if rc < 0:
        _build.check("decode_attn", -rc, "decode_keeps_scores")
    return bool(rc)


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pages [N, bs, ...] read through table [B, M] as contiguous rows [B,
    M * bs, ...]: block j of row b is page table[b, j]."""
    b, m = table.shape
    return pages[table.long()].reshape(b, m * pages.shape[1], *pages.shape[2:])


def _decode_pos(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).long().reshape(-1).expand(b)


def decode_attention_plain(q, k, v, pos, *, scale: float, k_scale=None, v_scale=None,
                           table=None, kv_valid=None, window: int = 0,
                           kv_window: Optional[int] = None,
                           alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``models/common.py:attend`` at one query token a row (JAX
    ``common.py:attend`` at T = 1), over the first ``kv_window`` columns of
    the rows (paged: the pages gathered into rows first), with the mask the
    engines build: column <= pos, > pos - window (window > 0) and kv_valid.
    ALiBi adds m_h * column after the scale (and the int8 key scale).
    f32 softmax; on the bf16 path (neither q nor the cache f32) the
    probabilities are rounded to bf16 before the value product."""
    b, hq, d = q.shape
    if table is not None:
        k, v = gather_pages(k, table), gather_pages(v, table)
        if k_scale is not None:
            k_scale, v_scale = gather_pages(k_scale, table), gather_pages(v_scale, table)
    n = kv_window or k.shape[1]
    k, v = k[:, :n], v[:, :n]
    hkv = k.shape[2]
    bf16 = not (q.dtype == torch.float32 or k.dtype == torch.float32)
    p = _decode_pos(pos, b, q.device)[:, None]
    col = torch.arange(n, device=q.device)[None, :]
    mask = col <= p
    if window:
        mask = mask & (col > p - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, :n]
    # the eager attend's ops at one query ([B, 1, Hkv, G, D])
    qf = q.float().reshape(b, 1, hkv, hq // hkv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale[:, :n].float().permute(0, 2, 1)[:, :, None, None, :]
    if alibi_slopes is not None:
        scores = scores + alibi_bias(alibi_slopes, n).reshape(1, hkv, hq // hkv, 1, n)
    scores = scores.masked_fill(~mask[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :n].float().permute(0, 2, 1)[:, :, None, None, :]
    if bf16:
        probs = probs.to(torch.bfloat16).float()
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                     scale: float, k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     table: Optional[torch.Tensor] = None,
                     kv_valid: Optional[torch.Tensor] = None, window: int = 0,
                     kv_window: Optional[int] = None,
                     alibi_slopes: Optional[torch.Tensor] = None,
                     recompute_scores: bool = False) -> torch.Tensor:
    """Attention of one query token a row, q [B, Hq, D], over its cache.
    Contiguous: k, v [B, S, Hkv, D]; paged (``table`` int32 [B, M]): k, v
    [N, bs, Hkv, D] pages, key j of row b in page table[b, j // bs]. An int8
    cache passes its f32 scales ([B, S, Hkv], or [N, bs, Hkv] pages). pos:
    each row's position (int, 0-d or [B]); keys 0..pos are attended, within
    ``window`` positions (a sliding window, 0: none) and where kv_valid
    (bool [B, >= kv_window]) holds; the first ``kv_window`` columns are
    scanned (default: all). ``alibi_slopes`` (f32 [Hq]) adds m_h * (key
    position). Returns [B, Hq, D] in q's dtype.

    CUDA tensors launch ``csrc/decode_attn.cu``, whose sums run in an order
    set by key position alone, so a row's result does not depend on the
    batch; what it refuses raises. It allocates nothing but the output: a
    cluster of CTAs a row and kv head keeps its score rows in shared memory
    where they fit (:func:`decode_keeps_scores`), else recomputes them, with
    the same bits; ``recompute_scores`` forces the second route (for
    tests). A row with no valid key comes out 0 from the kernel (the plain
    version averages it)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape != v.shape or k.ndim != 4 or k.shape[3] != d or hq % hkv
            or (table is None and k.shape[0] != b)
            or (table is not None and (table.ndim != 2 or table.shape[0] != b))):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"table {None if table is None else tuple(table.shape)}")
    if (k_scale is None) != (k.dtype != torch.int8) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale, any other none")
    slopes = _check_slopes(alibi_slopes, hq)
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, pos, scale=scale, k_scale=k_scale,
                                      v_scale=v_scale, table=table, kv_valid=kv_valid,
                                      window=window, kv_window=kv_window,
                                      alibi_slopes=slopes)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype not in _KV_KINDS \
            or v.dtype != k.dtype:
        raise TypeError(f"q {q.dtype} (f32 or bf16), cache {k.dtype}/{v.dtype} "
                        "(f32, bf16 or int8)")
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes D % 8 == 0 up to {_MAX_HEAD_DIM}")
    if hq // hkv > 64:
        raise ValueError(f"G={hq // hkv}: past the kernel's 64 query heads a kv head")
    kv_rows = k.shape[1]
    n_cols = kv_window or (kv_rows if table is None else table.shape[1] * kv_rows)
    tensors = [q, k, v] + [t for t in (k_scale, v_scale, table) if t is not None]
    if not all(t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v, the scales and the table must be contiguous, and q, k, "
                         "v 16-byte aligned")
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dtype != torch.int64:
        pos = pos.long()
    if pos.ndim > 1 or pos.numel() not in (1, b):
        raise ValueError(f"pos {tuple(pos.shape)}: an int, 0-d or [B]")
    pos_stride = pos.stride(0) if pos.numel() == b > 1 else 0
    if kv_valid is not None and (kv_valid.dtype != torch.bool or kv_valid.stride(-1) != 1
                                 or kv_valid.shape[0] != b or kv_valid.shape[1] < n_cols):
        raise ValueError(f"kv_valid {kv_valid.dtype} {tuple(kv_valid.shape)}: bool [B, "
                         f">= {n_cols}] with unit column stride")
    if table is not None and table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    out = torch.empty_like(q)
    fn = _build.function("decode_attn", "asq_decode_attention", _DECODE_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale),
            _build.ptr(v_scale), _build.ptr(table), pos.data_ptr(), _build.ptr(kv_valid),
            _build.ptr(slopes), out.data_ptr(), b, hq, hkv, d, kv_rows,
            table.shape[1] if table is not None else 0, pos_stride,
            kv_valid.stride(0) if kv_valid is not None else 0, n_cols, int(window),
            float(scale), _KV_KINDS[k.dtype], int(q.dtype == torch.bfloat16),
            int(q.dtype != torch.float32 and k.dtype != torch.float32), int(recompute_scores),
            _build.stream_ptr(q))
    _build.check("decode_attn", rc, "decode_attention")
    decode_attention.launches += 1
    if table is not None:
        decode_attention.paged_launches += 1
    return out


# launches of the CUDA kernel (plain CPU calls do not count); the paged
# addressing's alone in paged_launches (counted in launches too)
decode_attention.launches = 0
decode_attention.paged_launches = 0
