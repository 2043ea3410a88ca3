"""OPT family (bias-ful linears, LayerNorm, learned positions, ReLU): the
serving path of ``autosmoothquant_tpu/models/opt.py`` in PyTorch.

Both orderings are covered: pre-LN (``do_layer_norm_before``, most OPTs) and
post-LN (opt-350m), and the ``project_in`` / ``project_out`` pair of a model
whose ``word_embed_proj_dim`` differs from ``hidden_size``.

Params (see ``convert/from_jax.py``):
    {"embed":       {"w": [V, Dw]},
     "embed_pos":   {"w": [P + 2, D]},           # learned, offset 2 as HF's
     "project_in":  {"w": [Dw, D]},              # only when Dw != D
     "project_out": {"w": [D, Dw]},              # only when Dw != D
     "layers":      [{"ln1": {"w", "b"}, "attn": {"q", "k", "v", "o"},
                      "ln2": {"w", "b"}, "mlp": {"fc1", "fc2"}}, ...],
     "final_norm":  {"w", "b"},                  # pre-LN only
     "lm_head":     {"w": [Dw, V]}}              # kept float
Norm leaves are f32. A projection is {"w": float [in, out], "bias"} or a
quantized one (``models/llama.py`` lists the formats), each with its f32
"bias". There is no ``fuse_decode_projections``, as in the JAX family: a
layer runs 6 GEMMs.

The pre-LN int8 per-tensor block runs the residual add + ln2 + int8
quantize as one kernel (``kernels/fused.py:fused_add_layernorm_quant``, K6)
feeding fc1 its int8 input, with the ReLU in fc1's GEMM epilogue; ReLU
commutes with the cast to the compute dtype, so the bits are those of the
unfused chain.

Not ported yet: calibration capture, smooth, quantize and the mesh hints
(the port serves artifacts the JAX package wrote).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels.fused import fused_add_layernorm_quant
from ..quant.config import PER_TENSOR, QuantConfig
from ..runtime import resolve_device
from .common import (
    LinearKind,
    cache_mask_and_routing,
    fused_block_enabled,
    layer_norm,
    linear,
    linear_prequant,
    make_kv_cache,
    matmul_f32,
    uncached_mask_and_positions,
    update_and_attend,
)

POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    word_embed_proj_dim: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    enable_bias: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf) -> "OPTConfig":
        g = (lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict) \
            else (lambda k, d=None: getattr(hf, k, d))
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            word_embed_proj_dim=g("word_embed_proj_dim", g("hidden_size")),
            ffn_dim=g("ffn_dim"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            max_position_embeddings=g("max_position_embeddings", 2048),
            do_layer_norm_before=bool(g("do_layer_norm_before", True)),
            enable_bias=bool(g("enable_bias", True)),
        )


config_from_hf = OPTConfig.from_hf


def _layer_forward(h, lp, cfg: OPTConfig, qcfg: Optional[QuantConfig], mask,
                   cache, cache_index, compute_dtype, *, plain_causal=False,
                   chunk0=False, banded=False, banded_starts=None, kv_window=None):
    """One decoder layer; h: [B, T, D] in compute_dtype. The cache (if any)
    is written in place."""
    b, t, d = h.shape
    hd, n_h = cfg.head_dim, cfg.num_attention_heads
    eps = cfg.layer_norm_eps
    pre_ln = cfg.do_layer_norm_before

    # attention. Post-LN (opt-350m): the q/k/v input is no norm output, so its
    # per-tensor scale cannot be folded; it lives in quant_scale (SCALED)
    residual = h
    if pre_ln:
        x, qkv_kind = layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], eps), LinearKind.POST_NORM
    else:
        x, qkv_kind = h.float(), LinearKind.SCALED
    gran = qcfg.qkv if qcfg else PER_TENSOR
    q, k, v = (linear(x, lp["attn"][name], qcfg, gran, qkv_kind,
                      out_dtype=compute_dtype).reshape(b, t, n_h, hd)
               for name in ("q", "k", "v"))
    ctx = update_and_attend(q, k, v, cache, cache_index, mask,
                            1.0 / math.sqrt(hd), compute_dtype,
                            plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts,
                            kv_window=kv_window)
    attn_out = linear(ctx.reshape(b, t, d), lp["attn"]["o"], qcfg,
                      qcfg.out if qcfg else PER_TENSOR, LinearKind.SCALED,
                      out_dtype=compute_dtype)
    fc2_gran = qcfg.fc2 if qcfg else PER_TENSOR

    if pre_ln and fused_block_enabled(qcfg):
        # residual add + ln2 + int8 quantize in one kernel, feeding fc1 its
        # int8 input; ReLU in fc1's epilogue
        h2, x2_q = fused_add_layernorm_quant(
            residual.reshape(b * t, d), attn_out.reshape(b * t, d),
            lp["ln2"]["w"], lp["ln2"]["b"], eps=eps)
        h = h2.reshape(b, t, d)
        act = linear_prequant(x2_q, lp["mlp"]["fc1"], compute_dtype,
                              activation="relu").reshape(b, t, -1)
        out = linear(act, lp["mlp"]["fc2"], qcfg, fc2_gran, LinearKind.SCALED,
                     out_dtype=compute_dtype)
        return h + out

    h = residual + attn_out
    if not pre_ln:
        h = layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], eps).to(compute_dtype)

    residual = h
    if pre_ln:
        x2, fc1_kind = layer_norm(h, lp["ln2"]["w"], lp["ln2"]["b"], eps), LinearKind.POST_NORM
    else:
        x2, fc1_kind = h.float(), LinearKind.SCALED
    act = linear(x2, lp["mlp"]["fc1"], qcfg, qcfg.fc1 if qcfg else PER_TENSOR,
                 fc1_kind, out_dtype=compute_dtype)
    act = torch.clamp_min(act, 0)
    out = linear(act, lp["mlp"]["fc2"], qcfg, fc2_gran, LinearKind.SCALED,
                 out_dtype=compute_dtype)
    h = residual + out
    if not pre_ln:
        h = layer_norm(h, lp["ln2"]["w"], lp["ln2"]["b"], eps).to(compute_dtype)
    return h


def forward(params, input_ids: torch.Tensor, cfg: OPTConfig,
            quant_config: Optional[QuantConfig] = None, *,
            kv_cache=None, cache_index=None,
            kv_valid: Optional[torch.Tensor] = None,
            pad_starts: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            kv_window: Optional[int] = None,
            compute_dtype=torch.float32):
    """Run the decoder stack (HF OPTDecoder.forward). input_ids: int [B, T].

    Arguments as ``models/llama.py:forward``: kv_cache None or the list from
    ``init_kv_cache``, written in place at [cache_index, cache_index + T)
    (cache_index scalar or per row); kv_valid bool [B, S_max] (decode);
    pad_starts int32 [B] (ragged prefill); positions int [B, T] index the
    learned position table at ``positions + POS_OFFSET``; kv_window bounds
    the cache columns decode attention reads. Returns (hidden [B, T, Dw],
    kv_cache)."""
    b, t = input_ids.shape
    h = params["embed"]["w"][input_ids].to(compute_dtype)
    if "project_in" in params:
        h = h @ params["project_in"]["w"].to(compute_dtype)
    chunk0 = chunkN = plain_causal = False
    if kv_cache is not None:
        slots, mask, chunk0, chunkN = cache_mask_and_routing(
            kv_cache[0], cache_index, b, t, kv_valid, pad_starts, 0, kv_window)
        if positions is None:
            positions = slots  # no padding: the slot is the position
    else:
        positions, mask, plain_causal = uncached_mask_and_positions(
            b, t, positions, attention_mask, 0, h.device)
    h = h + params["embed_pos"]["w"][positions.long() + POS_OFFSET].to(compute_dtype)
    for i, lp in enumerate(params["layers"]):
        h = _layer_forward(
            h, lp, cfg, quant_config, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index,
            compute_dtype, plain_causal=plain_causal, chunk0=chunk0,
            banded=chunkN, banded_starts=pad_starts, kv_window=kv_window)
    if cfg.do_layer_norm_before and "final_norm" in params:
        h = layer_norm(h, params["final_norm"]["w"], params["final_norm"]["b"],
                       cfg.layer_norm_eps)
    h = h.to(compute_dtype)
    if "project_out" in params:
        h = h @ params["project_out"]["w"].to(compute_dtype)
    return h, kv_cache


def logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head (float): f32 [B, T, V], the product in the weight's dtype with
    f32 accumulation."""
    return matmul_f32(hidden, params["lm_head"]["w"])


def init_kv_cache(cfg: OPTConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """dtype torch.int8 selects the int8 cache (values + per-token-per-head
    scales)."""
    return make_kv_cache(cfg.num_hidden_layers, batch, max_len,
                         cfg.num_attention_heads, cfg.head_dim, dtype,
                         resolve_device(device))
