"""Llama family (Llama / Llama-2 / TinyLlama, GQA): the serving path of
``autosmoothquant_tpu/models/llama.py`` in PyTorch.

Params (see ``convert/from_jax.py``):
    {"embed":      {"w": [V, D]},
     "layers":     [{"ln1": {"w": f32 [D]},
                     "attn": {"q", "k", "v", "o"} or {"qkv", "o"},
                     "ln2": {"w": f32 [D]},
                     "mlp": {"gate", "up", "down"} or {"gateup", "down"}}, ...],
     "final_norm": {"w": f32 [D]},
     "lm_head":    {"w": [D, V]}}          # kept float
A projection is {"w": float [in, out]} or, quantized ([out, in] weights):
    int8  {"w": int8, "dequant_scale", ("quant_scale"), ("bias")}
    fp8   {"w": e4m3fn or e5m2, ("w_scale"), ("input_scale"),
           ("output_scale"), ("bias")}
    int4  {"w": uint8 [out, in'/2] nibbles, "w_scales": f32 [out, G],
           ("bias")}
An fp8 projection that the artifact's ignore patterns exempted stays float.

Not ported yet: calibration capture, smooth and quantize (the port serves
artifacts the JAX package wrote).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..kernels.fused import fused_add_rmsnorm_quant, rmsnorm_quant
from ..quant.config import PER_TENSOR, QuantConfig
from ..runtime import resolve_device
from .common import (
    LinearKind,
    activation,
    apply_rope,
    cache_mask_and_routing,
    fused_block_enabled,
    is_quantized,
    linear,
    linear_prequant,
    make_kv_cache,
    matmul_f32,
    rms_norm,
    rope_cos_sin,
    uncached_mask_and_positions,
    update_and_attend,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False      # Qwen2: q/k/v biases
    hidden_act: str = "silu"          # Gemma: "gelu_tanh"
    head_dim_override: int = 0
    sliding_window: int = 0           # Mistral; 0 = full attention

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (
            self.hidden_size // self.num_attention_heads)

    @classmethod
    def from_hf(cls, hf_config) -> "LlamaConfig":
        if isinstance(hf_config, dict):
            g = lambda k, d=None: hf_config.get(k, d)  # noqa: E731
        else:
            g = lambda k, d=None: getattr(hf_config, k, d)  # noqa: E731
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            num_key_value_heads=g("num_key_value_heads", g("num_attention_heads")),
            max_position_embeddings=g("max_position_embeddings", 2048),
            rms_norm_eps=g("rms_norm_eps", 1e-6),
            rope_theta=g("rope_theta", 10000.0),
            tie_word_embeddings=bool(g("tie_word_embeddings", False)),
            attention_bias=bool(g("attention_bias",
                                  g("model_type", "") == "qwen2")),
            hidden_act=("gelu_tanh" if str(
                g("hidden_activation", None) or g("hidden_act", "silu")
            ).startswith("gelu") else "silu"),
            head_dim_override=int(g("head_dim", 0) or 0),
            sliding_window=(int(g("sliding_window", 0) or 0)
                            if g("use_sliding_window", True) else 0),
        )


config_from_hf = LlamaConfig.from_hf


def _qkv_prescaled(qcfg: Optional[QuantConfig], attn) -> bool:
    """Whether q|k|v take per-tensor int8 whose input scale is folded into
    ln1 (the default QuantConfig): the first norm then runs as one
    RMSNorm + int8 kernel a row (``kernels/fused.py:rmsnorm_quant``)."""
    proj = attn["qkv"] if "qkv" in attn else attn["q"]
    return (qcfg is not None and qcfg.is_int8 and qcfg.qkv == PER_TENSOR
            and proj["w"].dtype == torch.int8)


def _layer_forward(h, lp, cfg: LlamaConfig, qcfg: Optional[QuantConfig], cos,
                   sin, mask, cache, cache_index, compute_dtype, *,
                   plain_causal=False, chunk0=False, banded=False,
                   banded_starts=None, kv_window=None):
    """One decoder layer; h: [B, T, D] in compute_dtype. The cache (if any)
    is written in place."""
    b, t, d = h.shape
    hd = cfg.head_dim
    n_q, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    qkv_gran = qcfg.qkv if qcfg else PER_TENSOR

    if _qkv_prescaled(qcfg, lp["attn"]):
        # RMSNorm + int8 quantize in one kernel, feeding q|k|v their int8
        # input directly
        x_q = rmsnorm_quant(h.reshape(b * t, d), lp["ln1"]["w"], eps=cfg.rms_norm_eps)
        if "qkv" in lp["attn"]:
            proj = linear_prequant(x_q, lp["attn"]["qkv"], compute_dtype).reshape(b, t, -1)
            q, k, v = proj.split([n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
        else:
            q, k, v = (linear_prequant(x_q, lp["attn"][name], compute_dtype).reshape(b, t, -1)
                       for name in ("q", "k", "v"))
    elif "qkv" in lp["attn"]:
        x = rms_norm(h, lp["ln1"]["w"], cfg.rms_norm_eps)
        # one GEMM over q|k|v; its dequant_scale is a per-column vector
        proj = linear(x, lp["attn"]["qkv"], qcfg, qkv_gran, LinearKind.POST_NORM,
                      out_dtype=compute_dtype)
        q, k, v = proj.split([n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
    else:
        x = rms_norm(h, lp["ln1"]["w"], cfg.rms_norm_eps)
        q, k, v = (linear(x, lp["attn"][name], qcfg, qkv_gran,
                          LinearKind.POST_NORM, out_dtype=compute_dtype)
                   for name in ("q", "k", "v"))
    q = apply_rope(q.reshape(b, t, n_q, hd), cos, sin)
    k = apply_rope(k.reshape(b, t, n_kv, hd), cos, sin)
    v = v.reshape(b, t, n_kv, hd)

    ctx = update_and_attend(q, k, v, cache, cache_index, mask,
                            1.0 / math.sqrt(hd), compute_dtype,
                            plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts,
                            kv_window=kv_window, sliding_window=cfg.sliding_window)
    attn_out = linear(ctx.reshape(b, t, n_q * hd), lp["attn"]["o"], qcfg,
                      qcfg.out if qcfg else PER_TENSOR, LinearKind.SCALED,
                      out_dtype=compute_dtype)

    inter = cfg.intermediate_size
    if fused_block_enabled(qcfg) and is_quantized(lp["attn"]["o"]):
        # residual add + RMSNorm + int8 quantize in one kernel, feeding the
        # gate|up GEMM its int8 input directly
        h2, x2_q = fused_add_rmsnorm_quant(h.reshape(b * t, d),
                                           attn_out.reshape(b * t, d),
                                           lp["ln2"]["w"], eps=cfg.rms_norm_eps)
        h = h2.reshape(b, t, d)
        if "gateup" in lp["mlp"]:
            proj = linear_prequant(x2_q, lp["mlp"]["gateup"], compute_dtype)
            gate, up = proj.reshape(b, t, 2 * inter).split([inter, inter], -1)
        else:
            gate = linear_prequant(x2_q, lp["mlp"]["gate"], compute_dtype).reshape(b, t, -1)
            up = linear_prequant(x2_q, lp["mlp"]["up"], compute_dtype).reshape(b, t, -1)
    else:
        h = h + attn_out
        x2 = rms_norm(h, lp["ln2"]["w"], cfg.rms_norm_eps)
        fc1 = qcfg.fc1 if qcfg else PER_TENSOR
        if "gateup" in lp["mlp"]:
            proj = linear(x2, lp["mlp"]["gateup"], qcfg, fc1, LinearKind.POST_NORM,
                          out_dtype=compute_dtype)
            gate, up = proj.split([inter, inter], dim=-1)
        else:
            gate = linear(x2, lp["mlp"]["gate"], qcfg, fc1, LinearKind.POST_NORM,
                          out_dtype=compute_dtype)
            up = linear(x2, lp["mlp"]["up"], qcfg, fc1, LinearKind.POST_NORM,
                        out_dtype=compute_dtype)
    act = (activation(gate.float(), cfg.hidden_act) * up.float()).to(compute_dtype)
    down = linear(act, lp["mlp"]["down"], qcfg, qcfg.fc2 if qcfg else PER_TENSOR,
                  LinearKind.SCALED, out_dtype=compute_dtype)
    return h + down


def forward(params, input_ids: torch.Tensor, cfg: LlamaConfig,
            quant_config: Optional[QuantConfig] = None, *,
            kv_cache=None, cache_index=None,
            kv_valid: Optional[torch.Tensor] = None,
            pad_starts: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            kv_window: Optional[int] = None,
            compute_dtype=torch.float32):
    """Run the decoder stack. input_ids: int [B, T].

    kv_cache: None, or the list from ``init_kv_cache``, written in place at
    slots [cache_index, cache_index + T); cache_index is an int, a 0-d int
    tensor on the device, or an int [B] tensor on the device (each row at
    its own slot; positions then [B, T], e.g. ``cache_index[:, None]``).
    kv_valid: bool [B, S_max] of valid cache slots (decode). pad_starts:
    int32 [B] left-pad lengths (ragged prefill). kv_window: a static bound
    on the cache columns decode attention reads (above every row's slot).
    A paged pool (``common.PagedKVPool`` / ``QuantPagedKVPool``) takes
    neither kv_valid nor pad_starts; its sliding window masks inside its
    attention. Returns (hidden [B, T, D], kv_cache)."""
    b, t = input_ids.shape
    h = params["embed"]["w"][input_ids].to(compute_dtype)
    chunk0 = chunkN = plain_causal = False
    if kv_cache is not None:
        slots, mask, chunk0, chunkN = cache_mask_and_routing(
            kv_cache[0], cache_index, b, t, kv_valid, pad_starts,
            cfg.sliding_window, kv_window)
        if positions is None:
            positions = slots
    else:
        positions, mask, plain_causal = uncached_mask_and_positions(
            b, t, positions, attention_mask, cfg.sliding_window, h.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = _layer_forward(
            h, lp, cfg, quant_config, cos, sin, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index,
            compute_dtype, plain_causal=plain_causal, chunk0=chunk0,
            banded=chunkN, banded_starts=pad_starts, kv_window=kv_window)
    # the final norm in one kernel a row, written in compute_dtype
    h = rmsnorm_quant(h.reshape(b * t, -1), params["final_norm"]["w"], eps=cfg.rms_norm_eps,
                      quantize=False).reshape(b, t, -1)
    return h, kv_cache


def logits(params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head (float): f32 [B, T, V], the product in the weight's dtype with
    f32 accumulation."""
    return matmul_f32(hidden, params["lm_head"]["w"])


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """dtype torch.int8 selects the int8 cache (values + per-token-per-head
    scales)."""
    return make_kv_cache(cfg.num_hidden_layers, batch, max_len,
                         cfg.num_key_value_heads, cfg.head_dim, dtype,
                         resolve_device(device))


def fuse_decode_projections(params) -> Dict[str, Any]:
    """Concatenate q|k|v and gate|up along the output dim so a layer runs 4
    GEMMs instead of 7, as the JAX package does for float, int8, fp8 and
    int4 params. Quantized weights ([N, K], int4 [N, K'/2]) and int4 group
    scales ([N, G]) join on dim 0, float weights ([in, out]) on dim 1, biases
    end to end. Scalar int8 dequant scales and fp8 w_scales expand to
    per-section column vectors; e5m2 carries none. A group whose sections
    differ in weight type or leaves (an fp8 projection left float by the
    ignore patterns) stays unfused. Static fp8 scales (input_scale,
    output_scale) do not survive fusion: ``Engine`` does not fuse such
    params."""

    def fuse(ps):
        w0 = ps[0]["w"]
        if any(p["w"].dtype != w0.dtype or set(p) != set(ps[0]) for p in ps):
            return None
        quant = is_quantized(ps[0])
        out = {"w": torch.cat([p["w"] for p in ps], dim=0 if quant else 1)}
        if "bias" in ps[0]:
            out["bias"] = torch.cat([p["bias"] for p in ps])
        for key in ("dequant_scale", "w_scale"):
            if key in ps[0]:
                out[key] = torch.cat([
                    p[key].float().reshape(-1).expand(p["w"].shape[0])
                    for p in ps])
        if "w_scales" in ps[0]:
            out["w_scales"] = torch.cat([p["w_scales"] for p in ps], dim=0)
        return out

    layers = []
    for lp in params["layers"]:
        attn, mlp = dict(lp["attn"]), dict(lp["mlp"])
        if "qkv" not in attn:
            qkv = fuse([attn[n] for n in ("q", "k", "v")])
            if qkv is not None:
                attn = {"qkv": qkv, "o": attn["o"]}
        if "gateup" not in mlp:
            gateup = fuse([mlp["gate"], mlp["up"]])
            if gateup is not None:
                mlp = {"gateup": gateup, "down": mlp["down"]}
        layers.append({**lp, "attn": attn, "mlp": mlp})
    return {**params, "layers": layers}
