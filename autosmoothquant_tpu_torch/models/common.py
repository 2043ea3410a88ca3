"""Shared building blocks of the model zoo: the main-path pieces of
``autosmoothquant_tpu/models/common.py`` in PyTorch.

Conventions carried over from the JAX package:
  - per-tensor activation scales live in norm weights (POST_NORM projections)
    or in a ``quant_scale`` leaf (SCALED projections), as device tensors
  - norms run in f32; int8, fp8 and int4 projections go through their GEMM
    kernels (int4 and fp8 norms keep their weights: no scale is folded)
  - the KV cache layout is [B, S_max, H_kv, Dh]; an int8 cache carries f32
    per-token-per-head scales [B, S_max, H_kv]

What differs: params are per-layer dicts, not stacked leaves under a scan;
the KV cache is a list of per-layer objects written in place; quantized
weights are [N, K] (int4: [N, K'/2] packed; see ``convert/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import (alibi_bias, decode_attention, flash_attention,
                                 flash_attention_banded, gather_pages)
from ..kernels.fp8 import fp8_matmul
from ..kernels.fused import rms_norm, rmsnorm_quant  # noqa: F401  (the families' norm)
from ..kernels.gemm import epilogue, int8_matmul
from ..kernels.int4 import _A8_MAX_M, int4_matmul
from ..quant import math as qmath
from ..quant.config import PER_TENSOR, PER_TOKEN, QuantConfig
from ..shard.mesh import Axis, Mesh, axis_of, sharded
from ..shard.sharding import TPPlan, tp_plan

# ---------------------------------------------------------------------------
# Norms and rotary embeddings (rms_norm: kernels/fused.py)
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 (OPT family), two-pass: the mean, then the mean of
    the centred squares. For a per-tensor int8 consumer ``weight`` and
    ``bias`` both hold the folded 1/input_scale."""
    xf = x.float()
    c = xf - xf.mean(dim=-1, keepdim=True)
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * qmath.rsqrt_rn(var + eps) * weight.float() + bias.float()


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """positions: int [...] -> cos/sin [..., head_dim] (HF rotate-half).
    inv_freq is computed in float64 on positions' device (no host copy in a
    decode step), then rounded to f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=positions.device) / head_dim
    inv_freq = (1.0 / (theta ** exps)).float()
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh] (broadcast over heads)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos[:, :, None, :] + rotated * sin[:, :, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------


class LinearKind:
    """POST_NORM: the input comes from a norm whose weight holds the folded
    per-tensor scale (quantize = round + clamp). SCALED: an interior
    activation with its own ``quant_scale``."""

    POST_NORM = "post_norm"
    SCALED = "scaled"


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result and f32 accumulation for any float dtype.
    On the card a bf16/f16 product asks cuBLAS for f32 output directly; on
    the CPU the operands are upcast (exact), the same arithmetic."""
    x = x.to(w.dtype)
    if w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return x.float() @ w.float()


def float_linear(x: torch.Tensor, p: dict, out_dtype=None) -> torch.Tensor:
    """Unquantized projection ([in, out] weight): the float model and the
    lm_head, which stays float."""
    out_dtype = out_dtype or x.dtype
    out = matmul_f32(x, p["w"])
    if p.get("bias") is not None:
        out = out + p["bias"].float()
    return out.to(out_dtype)


def quant_linear(x: torch.Tensor, p: dict, cfg: QuantConfig, granularity: str,
                 kind: str = LinearKind.POST_NORM, out_dtype=None) -> torch.Tensor:
    """One quantized projection, by ``cfg.type``. Leaves (weights [N, K],
    see ``convert/from_jax.py``; bias f32 [N] optional in every format):

    int8: w int8; dequant_scale f32 (0-d, or [N] for fused sections);
          quant_scale f32 0-d (SCALED per-tensor).
    fp8:  w e4m3fn or e5m2; w_scale f32 (0-d, or [N] for fused sections;
          e4m3 only); input_scale (and optionally output_scale) f32 0-d for
          the static scheme. A projection without input_scale (a fused one)
          quantizes dynamically, as the JAX package's fused path does.
    int4: w uint8 [N, K'/2] nibbles; w_scales f32 [N, G]. Activations are
          not pre-quantized, so the granularity does not apply."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    bias = p.get("bias")
    if cfg.type == "int4":
        out = int4_matmul(x2, p["w"], p["w_scales"], bias, out_dtype=out_dtype)
    elif cfg.type == "int8":
        if granularity == PER_TOKEN:
            q, tok_scale = qmath.quantize_act_per_token(x2)
            out = int8_matmul(q, p["w"], row_scale=tok_scale,
                              col_scale=p["dequant_scale"], bias=bias,
                              out_dtype=out_dtype)
        else:
            if kind == LinearKind.SCALED:
                q = qmath.quantize_act_static(x2, p["quant_scale"])
            else:
                q = qmath.quantize_act_prescaled(x2)
            out = int8_matmul(q, p["w"], col_scale=p["dequant_scale"],
                              bias=bias, out_dtype=out_dtype)
    elif cfg.type == "fp8_e5m2":
        # scale-free cast of the activation (no clamp), as the weights were
        out = fp8_matmul(x2.to(torch.float8_e5m2), p["w"], bias=bias,
                         out_dtype=out_dtype)
    elif cfg.type == "fp8_e4m3":
        fdt = torch.float8_e4m3fn
        if cfg.activation_scheme == "static" and "input_scale" in p:
            q = qmath.quantize_fp8_static(x2, p["input_scale"], fdt)
            out = fp8_matmul(q, p["w"], row_scale=p["input_scale"],
                             col_scale=p["w_scale"], bias=bias,
                             out_dtype=out_dtype)
            if "output_scale" in p:
                # the observer-tracked output re-quantization
                qo = qmath.quantize_fp8_static(out, p["output_scale"], fdt)
                out = (qo.float() * p["output_scale"]).to(out_dtype)
        else:
            if granularity == PER_TOKEN:
                q, s = qmath.quantize_fp8_per_token(x2, fdt)
            else:
                q, s = qmath.quantize_fp8_per_tensor(x2, fdt)
            out = fp8_matmul(q, p["w"], row_scale=s, col_scale=p["w_scale"],
                             bias=bias, out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown quant type {cfg.type!r}")
    return out.reshape(*lead, -1)


# weight dtypes of quantized projections (uint8: nibble-packed int4)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2, torch.uint8)


def is_quantized(p: dict) -> bool:
    return p["w"].dtype in QUANT_DTYPES


def linear(x, p, cfg: Optional[QuantConfig], granularity=PER_TENSOR,
           kind=LinearKind.POST_NORM, out_dtype=None):
    """Float or quantized by the weight's dtype: a projection that fp8
    ignore patterns left float stays float."""
    if cfg is None or not is_quantized(p):
        return float_linear(x, p, out_dtype)
    return quant_linear(x, p, cfg, granularity, kind, out_dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism (shard/mesh.py, shard/sharding.py)
# ---------------------------------------------------------------------------


def forward_plan(family: str, cfg, mesh: Optional[Mesh], qcfg=None,
                 capture_stats: bool = False) -> TPPlan:
    """A forward's :class:`~..shard.sharding.TPPlan`; calibration statistics
    are taken on one rank only."""
    if capture_stats and sharded(mesh):
        raise ValueError("calibration statistics are gathered on one rank (no mesh)")
    return tp_plan(family, cfg, mesh, qcfg)


def stage_input(embed, mesh: Optional[Mesh], shape, dtype, device) -> torch.Tensor:
    """The hidden state a rank's layers start from: ``embed()`` on the first
    stage (or without a stage axis), else what the previous stage sends, of
    ``shape`` and ``dtype`` on ``device`` (sequential stage placement; the
    microbatched schedule is ``shard/pipeline.py``'s)."""
    st = axis_of(mesh, "stage")
    if st.index == 0:
        return embed()
    return st.recv(shape, dtype, device, st.index - 1)


def stage_output(h: torch.Tensor, head, mesh: Optional[Mesh]) -> torch.Tensor:
    """``head(h)`` on the last stage (or without a stage axis): the model's
    final hidden state. An earlier stage sends ``h`` to the next one, waits
    until it has left, and returns it as it is (its own layers' output)."""
    st = axis_of(mesh, "stage")
    if st.index == st.size - 1:
        return head(h)
    st.send(h, st.index + 1)
    st.wait_sends()
    return h


def embed_tokens(params, input_ids: torch.Tensor, cfg, compute_dtype) -> torch.Tensor:
    """The token embedding [B, T, D] in compute_dtype: the first stage's part
    of the Llama, Gemma, Baichuan and Mixtral forwards (their ``embed``)."""
    return params["embed"]["w"][input_ids].to(compute_dtype)


def final_rms_norm(params, h: torch.Tensor, cfg, compute_dtype) -> torch.Tensor:
    """The final norm in one kernel a row (``rmsnorm_quant``, unquantized),
    in h's dtype: the last stage's part of those forwards (their ``head``)."""
    lead = h.shape[:-1]
    return rmsnorm_quant(h.reshape(-1, h.shape[-1]), params["final_norm"]["w"],
                         eps=cfg.rms_norm_eps, quantize=False).reshape(*lead, -1)


def global_rows(m: int, mesh: Optional[Mesh]) -> int:
    """The rows of the product a rank's m rows are part of: m, times the data
    axis where the static engine split the batch over it (``mesh.rows_split``),
    as JAX routes on the global M."""
    return m * axis_of(mesh, "data").size if getattr(mesh, "rows_split", False) else m


def row_linear(x, p, cfg: Optional[QuantConfig], granularity=PER_TENSOR,
               kind=LinearKind.SCALED, out_dtype=None, mesh: Optional[Mesh] = None,
               axis: str = "model"):
    """A row-parallel projection (o, down, fc2): x [..., K/m] is this rank's
    slice of the input columns, p's weight the matching slice of its rows,
    and the ranks of ``axis`` sum their partials (JAX's partitioner inserts
    that sum; here it is explicit). With the axis of size 1: :func:`linear`.

    int8: K1 gives the int32 accumulator (``out_dtype=torch.int32``), the
    ranks sum it, and K1's epilogue runs once on the sum, the bias added
    once: the bits of the unsharded product. Per-token scales (int8 and fp8
    dynamic) quantize against the whole row's absmax (a MAX over the ranks).
    fp8 and float: f32 partials summed, then the bias, the output
    re-quantization (static fp8) and the cast. int4: :func:`int4_matmul_tp`."""
    ax = axis_of(mesh, axis)
    if ax.size == 1:
        return linear(x, p, cfg, granularity, kind, out_dtype)
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    bias = p.get("bias")
    if cfg is not None and is_quantized(p) and cfg.type == "int4":
        out = int4_matmul_tp(x2, p, bias=bias, out_dtype=out_dtype, tp="row", mesh=mesh,
                             axis=axis)
        return out.reshape(*lead, -1)
    requant = None
    if cfg is None or not is_quantized(p):
        out = matmul_f32(x2, p["w"])
    elif cfg.type == "int8":
        rs = 1.0
        if granularity == PER_TOKEN:
            q, rs = qmath.quantize_act_per_token(x2, absmax=_row_absmax(x2, ax))
        elif kind == LinearKind.SCALED:
            q = qmath.quantize_act_static(x2, p["quant_scale"])
        else:
            q = qmath.quantize_act_prescaled(x2)
        acc = ax.all_reduce(int8_matmul(q, p["w"], out_dtype=torch.int32))
        out = epilogue(acc, rs, p["dequant_scale"], bias, out_dtype=out_dtype)
        return out.reshape(*lead, -1)
    elif cfg.type == "fp8_e5m2":
        out = fp8_matmul(x2.to(torch.float8_e5m2), p["w"], out_dtype=torch.float32)
    else:
        fdt = torch.float8_e4m3fn
        if cfg.activation_scheme == "static" and "input_scale" in p:
            q = qmath.quantize_fp8_static(x2, p["input_scale"], fdt)
            out = fp8_matmul(q, p["w"], row_scale=p["input_scale"], col_scale=p["w_scale"],
                             out_dtype=torch.float32)
            requant = p.get("output_scale")
        else:
            if granularity == PER_TOKEN:
                q, s = qmath.quantize_fp8_per_token(
                    x2, fdt, absmax=_row_absmax(x2, ax).to(x2.dtype))
            else:
                amax = ax.all_reduce(x2.abs().max().float().reshape(1), "max").reshape(())
                q, s = qmath.quantize_fp8_per_tensor(x2, fdt, amax=amax)
            out = fp8_matmul(q, p["w"], row_scale=s, col_scale=p["w_scale"],
                             out_dtype=torch.float32)
    ax.all_reduce(out)
    if bias is not None:
        out = out + bias.float()
    out = out.to(out_dtype)
    if requant is not None:
        qo = qmath.quantize_fp8_static(out, requant, torch.float8_e4m3fn)
        out = (qo.float() * requant).to(out_dtype)
    return out.reshape(*lead, -1)


def _row_absmax(x2: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The whole row's absmax [M, 1] in f32 of a row-parallel slice x2."""
    return ax.all_reduce(x2.abs().amax(dim=-1, keepdim=True).float(), "max")


def int4_matmul_tp(x2: torch.Tensor, p: dict, *, bias, out_dtype, tp: str,
                   mesh: Optional[Mesh] = None, axis: str = "model") -> torch.Tensor:
    """JAX ``int4_matmul_tp``: K5 on this rank's shard, routed W4A8 / W4A16
    on the whole product's M (:func:`global_rows`).

    tp="col": the packed weight, its group scales and the bias split on the
    output dimension; x is whole on every rank; exact.
    tp="row": x2 [M, K/m] is this rank's slice of the input. Split-K packing
    puts rank i's packed bytes [N, K'/2m] against two column ranges of x,
    [i kh, (i+1) kh) and [K'/2 + i kh, ...), so the ranks first gather x
    whole (an all-gather over the axis, in f32: exact), then each takes its
    two planes and their group scales (held whole) and quantizes against
    the whole row's per-token scale, as the unsharded product does. The f32
    partials are summed over the ranks (the one place row-parallel int4
    differs from the unsharded sum order), then the bias, then the cast."""
    ax = axis_of(mesh, axis)
    a8 = global_rows(x2.shape[0], mesh) <= _A8_MAX_M
    if tp == "col" or ax.size == 1:
        return int4_matmul(x2, p["w"], p["w_scales"], bias, out_dtype=out_dtype, a8=a8)
    packed, scales = p["w"], p["w_scales"]
    kh = packed.shape[1]
    k2 = kh * ax.size
    g2 = scales.shape[1] // 2
    gh = g2 // ax.size
    x = ax.all_gather(x2.float(), dim=-1).to(x2.dtype)
    if x.shape[1] < 2 * k2:
        x = F.pad(x, (0, 2 * k2 - x.shape[1]))
    ts = None
    if a8:
        absmax = x.abs().amax(dim=-1).float()
        ts = qmath.true_div(torch.clamp(absmax, min=1e-8), qmath.INT8_MAX)
    i = ax.index
    xl = torch.cat([x[:, i * kh:(i + 1) * kh], x[:, k2 + i * kh:k2 + (i + 1) * kh]], dim=1)
    sl = torch.cat([scales[:, i * gh:(i + 1) * gh], scales[:, g2 + i * gh:g2 + (i + 1) * gh]],
                   dim=1)
    out = int4_matmul(xl.contiguous(), packed, sl.contiguous(), None, out_dtype=torch.float32,
                      tok_scale=ts, a8=a8)
    ax.all_reduce(out)
    if bias is not None:
        out = out + bias.float().reshape(1, -1)
    return out.to(out_dtype)


def lm_logits(params, hidden: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The float lm_head: f32 [B, T, V], the product in the weight's dtype
    with f32 accumulation. Split over the vocab (its columns fewer than the
    embedding's rows), each rank's slice is gathered over "model"."""
    out = matmul_f32(hidden, params["lm_head"]["w"])
    ax = axis_of(mesh, "model")
    # a rank past the first stage holds no embedding; its lm_head is split
    # wherever the mesh is passed (``MeshModel.logits`` passes none otherwise)
    if ax.size > 1 and ("embed" not in params or
                        params["lm_head"]["w"].shape[1] != params["embed"]["w"].shape[0]):
        out = ax.all_gather(out, dim=-1)
    return out


def linear_prequant(x_q: torch.Tensor, p: dict, compute_dtype,
                    activation: Optional[str] = None) -> torch.Tensor:
    """Per-tensor int8 POST_NORM projection whose input is already int8 (from
    the fused add+norm+quant kernel); ``activation`` ("relu") goes into the
    GEMM's epilogue."""
    return int8_matmul(x_q, p["w"], col_scale=p["dequant_scale"],
                       bias=p.get("bias"), activation=activation,
                       out_dtype=compute_dtype)


def fused_block_enabled(qcfg: Optional[QuantConfig], capture: bool = False) -> bool:
    """Whether the decoder block runs the fused residual+norm+quant kernel:
    int8 with per-tensor fc1 and no statistics capture, on every device (the
    CPU runs the kernel's plain version), so tests and the card take one
    route."""
    return (qcfg is not None and not capture and qcfg.is_int8
            and qcfg.fc1 == PER_TENSOR)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCacheLayer:
    k: torch.Tensor  # [B, S_max, H_kv, Dh]
    v: torch.Tensor  # [B, S_max, H_kv, Dh]


@dataclasses.dataclass
class QuantKVCacheLayer:
    """int8 KV cache with per-token-per-head absmax scales."""

    k: torch.Tensor        # int8 [B, S_max, H_kv, Dh]
    v: torch.Tensor        # int8 [B, S_max, H_kv, Dh]
    k_scale: torch.Tensor  # f32  [B, S_max, H_kv]
    v_scale: torch.Tensor  # f32  [B, S_max, H_kv]


KVCache = List[Union[KVCacheLayer, QuantKVCacheLayer]]


@dataclasses.dataclass
class PagedLayer:
    """One layer's view of a paged pool: pages [N, bs, H_kv, Dh] (int8 pages
    with f32 scale pages [N, bs, H_kv]) and the block table int32 [B, M]."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass
class PagedKVPool:
    """Block-paged KV store (JAX ``common.py:PagedKVPool``): a page holds
    ``block_size`` consecutive tokens of one sequence, and row b's virtual
    block j lives in page ``table[b, j]``, so full prefix blocks can be
    shared between rows by pointing several table rows at one page. Mutable:
    the engine writes pages and refills the table in place.

    k, v:  [L, N, bs, H_kv, Dh]
    table: int32 [B, M]; the engine's scratch pages come first (page 0 on).
    Indexing gives a layer's :class:`PagedLayer` (views)."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor

    def __len__(self) -> int:
        return self.k.shape[0]

    def __getitem__(self, layer: int) -> PagedLayer:
        return PagedLayer(self.k[layer], self.v[layer], self.table)


@dataclasses.dataclass
class QuantPagedKVPool:
    """int8 block-paged KV store (JAX ``common.py:QuantPagedKVPool``):
    :class:`PagedKVPool` with per-token-per-head absmax scales in scale pages.

    k, v:             int8 [L, N, bs, H_kv, Dh]
    k_scale, v_scale: f32  [L, N, bs, H_kv]
    table:            int32 [B, M]"""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    table: torch.Tensor

    def __len__(self) -> int:
        return self.k.shape[0]

    def __getitem__(self, layer: int) -> PagedLayer:
        return PagedLayer(self.k[layer], self.v[layer], self.table,
                          self.k_scale[layer], self.v_scale[layer])


# int, a 0-d int tensor on the device (every row at one offset), or an int
# [B] tensor on the device (each row at its own offset: continuous batching)
CacheIndex = Union[int, torch.Tensor]


def make_kv_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype, device) -> KVCache:
    """dtype torch.int8 -> quantized cache; anything else -> plain cache."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    if dtype == torch.int8:
        return [QuantKVCacheLayer(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device))
            for _ in range(num_layers)]
    return [KVCacheLayer(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def _quantize_kv(x: torch.Tensor):
    """[B, T, H, Dh] -> (int8, f32 scales [B, T, H]); absmax over Dh."""
    xf = x.float()
    scale = qmath.true_div(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127).to(torch.int8)
    return q, scale


def _is_vector_index(cache_index: CacheIndex) -> bool:
    return isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1


def cache_slots(cache_index: CacheIndex, batch: int, t: int,
                device=None) -> torch.Tensor:
    """Cache-slot indices [B, T] of the tokens being written: a scalar
    cache_index writes every row at the same offset, an int [B] one each row
    at its own."""
    if isinstance(cache_index, torch.Tensor):
        device = cache_index.device
    ar = torch.arange(t, dtype=torch.int32, device=device)
    if _is_vector_index(cache_index):
        return cache_index[:, None] + ar[None, :]
    return (cache_index + ar)[None, :].expand(batch, t)


def _write(buf: torch.Tensor, val: torch.Tensor, cache_index: CacheIndex) -> None:
    """Write val [B, T, ...] into buf [B, S, ...] at cache_index, in place.
    A device-tensor index stays on the device (no host read). A vector index
    scatters row b to slots [index_b, index_b + T) (JAX ``_write``'s
    per-row scatter) through one ``index_copy_`` into buf's [B * S, ...]
    view; every slot must be < S, since a CUDA index out of bounds is a
    device assert (JAX drops such writes: callers give a parked row a
    scratch slot instead)."""
    t = val.shape[1]
    if isinstance(cache_index, int):
        buf[:, cache_index:cache_index + t] = val
    elif _is_vector_index(cache_index):
        b, s = buf.shape[:2]
        rows = torch.arange(b, device=buf.device)[:, None] * s
        flat = (rows + cache_slots(cache_index, b, t)).reshape(-1)
        buf.view(b * s, *buf.shape[2:]).index_copy_(
            0, flat, val.reshape(b * t, *val.shape[2:]).to(buf.dtype))
    else:
        idx = cache_index.reshape(1).long() + torch.arange(t, device=buf.device)
        buf.index_copy_(1, idx, val.to(buf.dtype))


def cache_write(cache, k: torch.Tensor, v: torch.Tensor,
                cache_index: CacheIndex, kv_quant=None) -> None:
    """Write new k/v ([B, T, H, Dh]) at cache_index; ``kv_quant`` reuses an
    already computed (kq, ks, vq, vs) for an int8 cache."""
    if isinstance(cache, QuantKVCacheLayer):
        kq, ks, vq, vs = kv_quant or (*_quantize_kv(k), *_quantize_kv(v))
        _write(cache.k, kq, cache_index)
        _write(cache.v, vq, cache_index)
        _write(cache.k_scale, ks, cache_index)
        _write(cache.v_scale, vs, cache_index)
    else:
        _write(cache.k, k.to(cache.k.dtype), cache_index)
        _write(cache.v, v.to(cache.v.dtype), cache_index)


def cache_update_and_read_raw(cache, k, v, cache_index):
    """Write new k/v, return (k_all, v_all, k_scale, v_scale): the raw cache
    (int8 for a quantized cache, with its scales for attend()'s factored
    dequant; scales None otherwise). cache None passes k/v through."""
    if cache is None:
        return k, v, None, None
    cache_write(cache, k, v, cache_index)
    if isinstance(cache, QuantKVCacheLayer):
        return cache.k, cache.v, cache.k_scale, cache.v_scale
    return cache.k, cache.v, None, None


# ---------------------------------------------------------------------------
# Masks and routing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeRows:
    """A chunk of T > 1 tokens a row at per-row positions (a speculative
    verify, a draft mirror) routed through decode attention on the card:
    the chunk's B x T queries become B x T rows of one launch, row r at
    position ``pos[r]`` reading through ``table[r]``. A paged layer's table
    has each row repeated T times; a contiguous cache [B, S, ...] is seen as
    B pages of S slots, row r reading page r // T. ``kv_valid`` is the rows'
    readable columns (each row's repeated), or None."""

    table: torch.Tensor                # int32 [B * T, M]
    pos: torch.Tensor                  # int64 [B * T]
    kv_valid: Optional[torch.Tensor]   # bool [B * T, S] or None


def decode_rows(table: Optional[torch.Tensor], slots: torch.Tensor, kv_valid) -> DecodeRows:
    """The :class:`DecodeRows` of a chunk at ``slots`` [B, T]: a paged
    ``table`` [B, M] repeated, or (None) one page a row of a contiguous
    cache. Built once a forward, ahead of the layers."""
    b, t = slots.shape
    if table is None:
        table = torch.div(torch.arange(b * t, dtype=torch.int32, device=slots.device), t,
                          rounding_mode="floor")[:, None]
    else:
        table = table.repeat_interleave(t, dim=0)
    if kv_valid is not None:
        kv_valid = kv_valid.repeat_interleave(t, dim=0)
    return DecodeRows(table, slots.reshape(-1).long(), kv_valid)


def cache_mask_and_routing(kv_cache, cache_index: CacheIndex, b: int, t: int,
                           kv_valid, pad_starts, sliding_window: int = 0,
                           kv_window: Optional[int] = None):
    """The cached-forward prologue: (slots, mask, chunk0, chunkN).

    slots [B, T]: cache slots being written (the rope positions when there is
    no padding), per row for a vector cache_index. chunk0: prefill into an
    empty cache (index 0, no pads, no kv_valid) -> causal flash attention
    over the chunk. chunkN: any other multi-token chunk at a scalar index
    with no kv_valid -> banded flash attention over the cache rows,
    pad_starts as each row's first valid column. mask (bool [B, 1, T, S]) is
    built only for the eager route that reads it, over the first
    ``kv_window`` cache columns where given (else all S_max), per row: col <=
    slot, and col > slot - window with a sliding window. A decode step (T =
    1) builds none: decode attention takes the slots and the window itself,
    and ``mask`` is then the bool [B, S] of columns it may read (kv_valid,
    or the columns from each row's pad_starts on) or None for all. A paged
    layer (:class:`PagedLayer`) masks by key position inside its attention:
    slots only, and kv_valid and pad_starts must be None (paged rows are
    unpadded). On the card a chunk of T > 1 at a vector cache_index with no
    pad_starts (a speculative verify) gets a :class:`DecodeRows` as its
    mask, contiguous or paged: each of its queries then attends as a decode
    step at that position does, in the same kernel and the same sum order."""
    if kv_cache is None:
        raise ValueError("cache_mask_and_routing needs a cache")
    rows = t > 1 and _is_vector_index(cache_index) and kv_cache.k.is_cuda
    if isinstance(kv_cache, PagedLayer):
        if kv_valid is not None or pad_starts is not None:
            raise ValueError("a paged KV pool serves unpadded rows: no kv_valid or "
                             "pad_starts")
        slots = cache_slots(cache_index, b, t, kv_cache.k.device)
        mask = decode_rows(kv_cache.table, slots, None) if rows else None
        return slots, mask, False, False
    slots = cache_slots(cache_index, b, t, kv_cache.k.device)
    if rows and pad_starts is None:
        return slots, decode_rows(None, slots, kv_valid), False, False
    if t == 1:
        valid = kv_valid
        if valid is None and pad_starts is not None:
            col = torch.arange(kv_cache.k.shape[1], device=kv_cache.k.device)
            valid = col[None, :] >= pad_starts.reshape(-1, 1)
        return slots, valid, False, False
    scalar = not _is_vector_index(cache_index)
    chunk0 = (kv_valid is None and pad_starts is None
              and (not sliding_window or t <= sliding_window)
              and isinstance(cache_index, int) and cache_index == 0)
    chunkN = kv_valid is None and scalar and not sliding_window and not chunk0
    mask = None
    if not (chunk0 or chunkN):
        s_max = kv_window or kv_cache.k.shape[1]
        col = torch.arange(s_max, dtype=torch.int32,
                           device=kv_cache.k.device)[None, None, None, :]
        sl = slots[:, None, :, None]
        mask = col <= sl
        if sliding_window:
            mask = mask & (col > sl - sliding_window)
        if kv_valid is None and pad_starts is not None:
            mask = mask & (col >= pad_starts.reshape(-1, 1, 1, 1))
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, :s_max]
    return slots, mask, chunk0, chunkN


def uncached_mask_and_positions(b: int, t: int, positions, attention_mask,
                                sliding_window: int, device):
    """The no-cache prologue: (positions [B, T], causal mask, plain_causal)."""
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=device)[None, :].expand(b, t)
    col = torch.arange(t, device=device)[None, None, None, :]
    row = torch.arange(t, device=device)[None, None, :, None]
    mask = col <= row
    if sliding_window:
        mask = mask & (col > row - sliding_window)
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].bool()
    plain_causal = attention_mask is None and not sliding_window
    return positions, mask, plain_causal


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _dequant_kv(x: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (x.float() * scale[..., None]).to(dtype)


def update_and_attend(q, k, v, cache, cache_index: CacheIndex, mask, scale: float,
                      compute_dtype, *, plain_causal=False, chunk0_causal=False,
                      banded=False, banded_starts=None,
                      kv_window: Optional[int] = None, sliding_window: int = 0,
                      alibi_slopes: Optional[torch.Tensor] = None):
    """Cache write + attention for one layer (the routes of the JAX
    ``update_and_attend``). q/k/v: [B, T, H(kv), Dh] after RoPE.
    ``alibi_slopes`` (f32 [Hq], Baichuan-13B): every route adds m_h * (key
    slot) to the scores, the JAX package's ``alibi_bias``.

    chunk0_causal: prefill into an empty cache. The cache is written, then the
    chunk attends to itself through causal flash attention; with an int8
    cache it sees the int8 round trip, as later decode steps will.
    banded: a multi-token chunk against the cache rows (ragged left-padded
    prompts, later prefill chunks): banded flash attention over the
    dequantized rows.
    A decode step (T = 1): decode attention over the raw cache at each row's
    slot (``kernels/attention.py:decode_attention``), its first ``kv_window``
    columns where given, ``mask`` the bool [B, S] of readable columns or
    None (``cache_mask_and_routing``), ``sliding_window`` its window.
    A paged layer (:class:`PagedLayer`): :func:`paged_update_and_attend`.
    ``mask`` a :class:`DecodeRows` (a verify chunk on the card): the chunk
    written, then decode attention over its B x T queries as rows.
    Otherwise: eager attention over the cache under ``mask``."""
    b, t = q.shape[:2]
    if isinstance(cache, PagedLayer):
        return paged_update_and_attend(q, k, v, cache, cache_index, scale, compute_dtype,
                                       kv_window=kv_window, sliding_window=sliding_window,
                                       rows=mask, alibi_slopes=alibi_slopes)
    quant = isinstance(cache, QuantKVCacheLayer)
    if chunk0_causal and t > 1 and cache is not None:
        if quant:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache_write(cache, k, v, cache_index, kv_quant=(kq, ks, vq, vs))
            k_att = _dequant_kv(kq, ks, compute_dtype)
            v_att = _dequant_kv(vq, vs, compute_dtype)
        else:
            cache_write(cache, k, v, cache_index)
            k_att, v_att = k.to(compute_dtype), v.to(compute_dtype)
        return attend(q, k_att, v_att, None, scale, plain_causal=True,
                      alibi_slopes=alibi_slopes)
    if banded and t > 1 and cache is not None:
        cache_write(cache, k, v, cache_index)
        ct = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
        if quant:
            k_l = _dequant_kv(cache.k, cache.k_scale, ct)
            v_l = _dequant_kv(cache.v, cache.v_scale, ct)
        else:
            k_l, v_l = cache.k.to(ct), cache.v.to(ct)
        out = flash_attention_banded(q.to(ct), k_l, v_l, cache_index,
                                     banded_starts, sm_scale=scale, alibi_slopes=alibi_slopes)
        return out.to(q.dtype)
    k_all, v_all, ks, vs = cache_update_and_read_raw(cache, k, v, cache_index)
    if isinstance(mask, DecodeRows):
        return attend_rows(q, k_all, v_all, mask, scale, ks, vs, sliding_window, kv_window,
                           alibi_slopes)
    if t == 1 and cache is not None:
        out = decode_attention(q[:, 0], k_all, v_all, cache_index, scale=scale,
                               k_scale=ks, v_scale=vs, kv_valid=mask,
                               window=sliding_window, kv_window=kv_window,
                               alibi_slopes=alibi_slopes)
        return out[:, None]
    if kv_window is not None:
        k_all, v_all = k_all[:, :kv_window], v_all[:, :kv_window]
        if ks is not None:
            ks, vs = ks[:, :kv_window], vs[:, :kv_window]
    return attend(q, k_all, v_all, mask, scale, plain_causal=plain_causal,
                  k_scale=ks, v_scale=vs, alibi_slopes=alibi_slopes)


def attend_rows(q, k, v, rows: DecodeRows, scale: float, k_scale=None, v_scale=None,
                sliding_window: int = 0, kv_window: Optional[int] = None,
                alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, T, Hq, D] through decode attention as B x T rows (``rows``,
    :class:`DecodeRows`) over the raw cache or pages k / v, already written
    (a row's key positions are its cache slots, or its logical positions
    through the table: ALiBi's column either way)."""
    b, t = q.shape[:2]
    out = decode_attention(q.reshape(b * t, *q.shape[2:]), k, v, rows.pos, scale=scale,
                           k_scale=k_scale, v_scale=v_scale, table=rows.table,
                           kv_valid=rows.kv_valid, window=sliding_window, kv_window=kv_window,
                           alibi_slopes=alibi_slopes)
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


def make_paged_pool(num_layers: int, num_pages: int, block_size: int, num_kv_heads: int,
                    head_dim: int, table: torch.Tensor, dtype, device):
    """dtype torch.int8 -> :class:`QuantPagedKVPool` (scales 1); anything
    else -> :class:`PagedKVPool` (zeros). ``table`` is the pool's block
    table, on ``device``."""
    shape = (num_layers, num_pages, block_size, num_kv_heads, head_dim)
    if dtype == torch.int8:
        return QuantPagedKVPool(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
            table=table)
    return PagedKVPool(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device), table=table)


def paged_slots(table: torch.Tensor, positions: torch.Tensor, block_size: int) -> torch.Tensor:
    """The flat slots [B * T] of absolute token positions [B, T] in a paged
    layer's [N * bs, ...] view, routed through table [B, M]. A block index
    past the table reads its last column (JAX clamps the gather too); the
    engines keep that column on the scratch page, where writes past a row's
    blocks land (a CUDA index out of bounds would be a device assert)."""
    blk = torch.clamp(torch.div(positions, block_size, rounding_mode="floor"),
                      max=table.shape[1] - 1).long()
    pid = torch.gather(table.long(), 1, blk)
    return (pid * block_size + torch.remainder(positions, block_size)).reshape(-1)


def _paged_write(pages: torch.Tensor, val: torch.Tensor, slots: torch.Tensor) -> None:
    """Write val [B, T, H(, D)] into pages [N, bs, H(, D)] at ``slots``
    (:func:`paged_slots`), in place: one ``index_copy_`` into the pages'
    [N * bs, ...] view (JAX ``common.py:_paged_write``)."""
    pages.view(-1, *pages.shape[2:]).index_copy_(
        0, slots, val.reshape(-1, *val.shape[2:]).to(pages.dtype))


def paged_attend_plain(q, k_pages, v_pages, table, pos_q, scale: float, compute_dtype,
                       m_used: Optional[int] = None, ks_pages=None, vs_pages=None,
                       sliding_window: int = 0,
                       alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX ``common.py:paged_attend``: an online-softmax scan over virtual
    blocks. q [B, T, Hq, D] (after RoPE); k_pages / v_pages [N, bs, Hkv, D]
    (a layer's pages); table [B, M]; pos_q [B, T] the queries' absolute
    positions (key position <= query position; within ``sliding_window``
    where > 0); ks_pages / vs_pages the int8 pages' scales [N, bs, Hkv],
    factored out of the products; ``alibi_slopes`` f32 [Hq] adds m_h * key
    position; the first ``m_used`` blocks are scanned."""
    b, t, hq, d = q.shape
    bs, hkv = k_pages.shape[1], k_pages.shape[2]
    m = table.shape[1] if m_used is None else min(m_used, table.shape[1])
    g = hq // hkv
    qf = (q.float() * scale).reshape(b, t, hkv, g, d)
    slp = alibi_slopes.float().reshape(hkv, g) if alibi_slopes is not None else None
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    mx = torch.full((b, t, hkv, g), -1e30, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, t, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, t, hkv, g, d), dtype=torch.float32, device=q.device)
    for j in range(m):
        pid = table[:, j].long()
        kb = k_pages[pid].float()                                  # [B, bs, Hkv, D]
        vb = v_pages[pid].float()
        sc = torch.einsum("bthgd,bshd->bthgs", qf, kb)             # [B, T, Hkv, G, bs]
        if ks_pages is not None:
            sc = sc * ks_pages[pid].permute(0, 2, 1)[:, None, :, None, :]
        posk = j * bs + torch.arange(bs, device=q.device)
        if slp is not None:
            sc = sc + slp[None, None, :, :, None] * posk.float()[None, None, None, None, :]
        valid = posk[None, None, :] <= pos_q[:, :, None]           # [B, T, bs]
        if sliding_window:
            valid = valid & (posk[None, None, :] > pos_q[:, :, None] - sliding_window)
        sc = torch.where(valid[:, :, None, None, :], sc, neg)
        nmx = torch.maximum(mx, sc.amax(dim=-1))
        corr = torch.exp(mx - nmx)
        p = torch.exp(sc - nmx[..., None])
        s = s * corr + p.sum(dim=-1)
        if vs_pages is not None:
            p = p * vs_pages[pid].permute(0, 2, 1)[:, None, :, None, :]
        acc = acc * corr[..., None] + torch.einsum("bthgs,bshd->bthgd", p, vb)
        mx = nmx
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.reshape(b, t, hq, d).to(compute_dtype)


def paged_attend(q, layer: PagedLayer, cache_index: CacheIndex, pos_q, scale: float,
                 compute_dtype, kv_window: Optional[int] = None,
                 sliding_window: int = 0,
                 alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q [B, T, Hq, D] at positions pos_q [B, T] over a paged
    layer whose pages already hold the chunk (write, then attend). CPU:
    :func:`paged_attend_plain` for any T, its scan bounded by
    ceil(kv_window / bs) blocks. Card: T = 1 is decode attention through the
    page table (one kernel); T > 1 (a suffix or a chunk) is
    :func:`paged_gather_attend`."""
    b, t = q.shape[:2]
    bs = layer.k.shape[1]
    if not q.is_cuda:
        m_used = -(-kv_window // bs) if kv_window is not None else None
        return paged_attend_plain(q, layer.k, layer.v, layer.table, pos_q, scale,
                                  compute_dtype, m_used, layer.k_scale, layer.v_scale,
                                  sliding_window, alibi_slopes)
    if t == 1:
        out = decode_attention(q[:, 0], layer.k, layer.v, cache_index, scale=scale,
                               k_scale=layer.k_scale, v_scale=layer.v_scale,
                               table=layer.table, window=sliding_window,
                               kv_window=kv_window, alibi_slopes=alibi_slopes)
        return out[:, None]
    return paged_gather_attend(q, layer, cache_index, pos_q, scale, kv_window,
                               sliding_window, alibi_slopes)


def paged_gather_attend(q, layer: PagedLayer, cache_index: CacheIndex, pos_q, scale: float,
                        kv_window: Optional[int] = None,
                        sliding_window: int = 0,
                        alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The card's route for a chunk of T > 1 (a suffix, a prefill chunk):
    each row's mapped pages gathered into contiguous rows (a copy at
    admission only), then banded flash attention from column 0 (rows at one
    scalar position), or, with a sliding window or rows at their own
    positions, the eager attention under the mask the contiguous engine
    builds for them (``cache_mask_and_routing``): key column <= pos_q, and
    > pos_q - window, over the first ``kv_window`` columns."""
    k_rows, v_rows = gather_pages(layer.k, layer.table), gather_pages(layer.v, layer.table)
    if _is_vector_index(cache_index) or sliding_window:
        n = min(kv_window or k_rows.shape[1], k_rows.shape[1])
        col = torch.arange(n, device=q.device)[None, None, None, :]
        sl = pos_q[:, None, :, None]
        mask = col <= sl
        if sliding_window:
            mask = mask & (col > sl - sliding_window)
        ks = vs = None
        if layer.k_scale is not None:
            ks = gather_pages(layer.k_scale, layer.table)[:, :n]
            vs = gather_pages(layer.v_scale, layer.table)[:, :n]
        return attend(q, k_rows[:, :n], v_rows[:, :n], mask, scale, k_scale=ks, v_scale=vs,
                      alibi_slopes=alibi_slopes)
    ct = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    if layer.k_scale is not None:
        k_rows = _dequant_kv(k_rows, gather_pages(layer.k_scale, layer.table), ct)
        v_rows = _dequant_kv(v_rows, gather_pages(layer.v_scale, layer.table), ct)
    out = flash_attention_banded(q.to(ct), k_rows.to(ct), v_rows.to(ct), cache_index, 0,
                                 sm_scale=scale, alibi_slopes=alibi_slopes)
    return out.to(q.dtype)


def paged_update_and_attend(q, k, v, layer: PagedLayer, cache_index: CacheIndex,
                            scale: float, compute_dtype, kv_window: Optional[int] = None,
                            sliding_window: int = 0,
                            rows: Optional[DecodeRows] = None,
                            alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the chunk's K/V (int8 pages: quantized, with their scales) into
    the layer's pages at slots cache_index + [0, T), then :func:`paged_attend`
    (JAX ``common.py:paged_update_and_attend``), or with ``rows`` (a verify
    chunk on the card) decode attention over its queries as rows."""
    b, t = q.shape[:2]
    pos = cache_slots(cache_index, b, t, q.device)
    slots = paged_slots(layer.table, pos, layer.k.shape[1])
    if layer.k_scale is not None:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for pages, val in ((layer.k, kq), (layer.v, vq), (layer.k_scale, ks),
                           (layer.v_scale, vs)):
            _paged_write(pages, val, slots)
    else:
        _paged_write(layer.k, k, slots)
        _paged_write(layer.v, v, slots)
    if rows is not None:
        return attend_rows(q, layer.k, layer.v, rows, scale, layer.k_scale, layer.v_scale,
                           sliding_window, kv_window, alibi_slopes)
    return paged_attend(q, layer, cache_index, pos, scale, compute_dtype, kv_window,
                        sliding_window, alibi_slopes)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
           scale: float, plain_causal: bool = False,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None,
           alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Tq, H, Dh]; k/v: [B, Tk, H_kv, Dh]; mask: bool [B, 1, Tq, Tk].
    GQA by head groups; softmax in f32. ``alibi_slopes`` (f32 [H]) adds m_h
    * (key column) after the scale, before the mask (JAX ``alibi_bias``).

    k/v may be the raw int8 cache with per-token-per-head scales
    [B, Tk, H_kv]: the dequant factors out of the products exactly (scores
    *= k_scale, probs *= v_scale), so no dequantized copy is made.

    plain_causal (no padding, unquantized k/v) goes to causal flash
    attention. On the bf16 path the products take bf16 operands with f32
    accumulation (operands upcast exactly; probabilities rounded to bf16
    first), as the JAX package runs them."""
    if plain_causal and k_scale is None:
        return flash_attention(q, k, v, sm_scale=scale, causal=True, alibi_slopes=alibi_slopes)
    b, tq, h, dh = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    g = h // h_kv
    bf16 = not (q.dtype == torch.float32 or k.dtype == torch.float32)
    qf = q.float().reshape(b, tq, h_kv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    if alibi_slopes is not None:
        scores = scores + alibi_bias(alibi_slopes, tk).reshape(1, h_kv, g, 1, tk)
    scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    if bf16:
        probs = probs.to(torch.bfloat16).float()
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, tq, h, dh).to(q.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Quantization of float params (the families' quantize)
# ---------------------------------------------------------------------------


def absmax_ch(x: torch.Tensor) -> torch.Tensor:
    """Per-channel absmax over every row: [..., C] -> [C] (a calibration
    statistic)."""
    return x.reshape(-1, x.shape[-1]).abs().amax(dim=0)


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a numpy array (read-only ones included) as a CPU
    tensor of its own copy."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def fp8_observer_scales_of(stats, proj_input) -> Dict[str, torch.Tensor]:
    """Each projection's fp8 input and output scales [L] (absmax / 448) from
    an observer pass's statistics; ``proj_input``: projection -> its
    per-channel input statistic."""
    out = {}
    for proj, key in proj_input.items():
        out[f"{proj}_input_scale"] = qmath.true_div(as_tensor(stats[key]).amax(dim=-1),
                                                    qmath.FP8_E4M3_MAX)
        out[f"{proj}_output_scale"] = qmath.true_div(as_tensor(stats[f"{proj}_out_absmax"]),
                                                     qmath.FP8_E4M3_MAX)
    return out


def scales_on(scales, device) -> Dict[str, torch.Tensor]:
    """Every scale as a tensor on ``device``: a quantize divides by them,
    and a CUDA tensor divided by a CPU scalar is multiplied by its rounded
    reciprocal instead."""
    return {k: as_tensor(v).to(device) for k, v in scales.items()}


def pack_int4(p, group_size):
    """A float [in, out] projection as grouped int4 ([out, in'/2] nibbles,
    [out, G] scales), its bias carried as it is."""
    packed, scales = qmath.quantize_weight_int4_grouped(p["w"], group_size)
    out = {"w": packed.t().contiguous(), "w_scales": scales.t().contiguous()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def pack_int8(p, input_scale, gran, kind, bias=None):
    """A float [in, out] projection as per-tensor int8 ([out, in]) with its
    dequant (and, for a SCALED per-tensor input, quant) scale."""
    qw, w_scale = qmath.quantize_weight_per_tensor_absmax(p["w"])
    out = {"w": qw.t().contiguous()}
    if bias is not None:
        out["bias"] = bias
    if gran == PER_TENSOR:
        out["dequant_scale"] = w_scale * input_scale
        if kind == LinearKind.SCALED:
            out["quant_scale"] = input_scale
    else:
        out["dequant_scale"] = w_scale
    return out


def pack_fp8(p, qcfg: QuantConfig, bias=None):
    """A float [in, out] projection as fp8 ([out, in]): e4m3 with its
    per-tensor scale, e5m2 a scale-free cast."""
    extra = {} if bias is None else {"bias": bias}
    if qcfg.type == "fp8_e5m2":
        return {"w": p["w"].to(qcfg.fp8_dtype).t().contiguous(), **extra}
    qw, w_scale = qmath.quantize_fp8_per_tensor(p["w"], qcfg.fp8_dtype)
    return {"w": qw.t().contiguous(), "w_scale": w_scale, **extra}


def add_static_fp8_scales(layers, qcfg: QuantConfig, scales, groups, legacy, *,
                          ignore, quantize_output, observer_scales):
    """Static fp8 e4m3: each projection's input_scale (and, with
    ``quantize_output``, output_scale) from the observer pass, or, without
    one, from the int8 layer scales (``legacy``: projection -> scale key,
    times 127 / 448). ``layers`` is written in place."""
    if observer_scales is not None:
        obs = scales_on(observer_scales, layers[0]["ln1"]["w"].device)
        for i, lp in enumerate(layers):
            for name, grp in groups.items():
                if name in ignore:
                    continue
                lp[grp][name]["input_scale"] = obs[f"{name}_input_scale"][i]
                if quantize_output:
                    lp[grp][name]["output_scale"] = obs[f"{name}_output_scale"][i]
        return
    if scales is None:
        raise ValueError("fp8 static needs observer scales")
    if quantize_output:
        raise ValueError("quantize_output needs observer_scales")
    sc = scales_on(scales, layers[0]["ln1"]["w"].device)
    for i, lp in enumerate(layers):
        for name, key in legacy.items():
            if name not in ignore:
                lp[groups[name]][name]["input_scale"] = qmath.true_div(
                    sc[key][i] * 127.0, qmath.FP8_E4M3_MAX)
