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

The quantize path (JAX ``llama.py:182-283``, ``:437-672``): ``forward(...,
capture_stats=True)`` also returns the calibration statistics, stacked
[L, ...] under ``STAT_KEYS``; ``smooth`` migrates activation outliers into
the q|k|v and gate|up weights; ``layer_scales`` and ``fp8_observer_scales``
turn statistics into per-layer scales; ``quantize`` writes the quantized
params ([out, in] weights, unfused: the engines fuse at load).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..kernels.fused import fused_add_rmsnorm_quant
from ..quant import math as qmath
from ..quant.config import PER_TENSOR, QuantConfig
from ..runtime import resolve_device
from .common import (
    LinearKind,
    activation,
    apply_rope,
    cache_mask_and_routing,
    forward_plan,
    fp8_observer_scales_of,
    fused_block_enabled,
    absmax_ch,
    add_rms_norm,
    add_static_fp8_scales,
    as_tensor,
    is_quantized,
    linear,
    linear_prequant,
    lm_logits,
    make_kv_cache,
    norm_dtype,
    pack_fp8,
    pack_int4,
    pack_int8,
    rope_cos_sin,
    row_linear,
    scales_on,
    stage_input,
    stage_output,
    uncached_mask_and_positions,
    update_and_attend,
    embed_tokens as embed,
    final_rms_norm as head,
)

FAMILY = "llama"


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
    ln1 (the default QuantConfig): the first norm then writes their int8
    input (``kernels/fused.py:rmsnorm_quant``)."""
    proj = attn["qkv"] if "qkv" in attn else attn["q"]
    return (qcfg is not None and qcfg.is_int8 and qcfg.qkv == PER_TENSOR
            and proj["w"].dtype == torch.int8)


def _layer_forward(h, lp, cfg: LlamaConfig, qcfg: Optional[QuantConfig], cos,
                   sin, mask, cache, cache_index, compute_dtype, *, pending=None,
                   plain_causal=False, chunk0=False, banded=False,
                   banded_starts=None, kv_window=None, stats=None, plan=None, mesh=None):
    """One decoder layer; h: [B, T, D] in compute_dtype, and ``pending`` the
    previous layer's MLP output not yet added to h (None: h is whole). The
    cache (if any) is written in place. Each norm is one ``rmsnorm_quant``
    launch with the add before it folded in (the first norm adds
    ``pending``, the second the attention output), or K2 where the fused
    block runs, or the torch ops before int4 projections
    (``common.py:norm_dtype``). Returns (h, down): the stream after attention's add and
    this layer's MLP output, which the next norm adds (the next layer's
    first norm, or the final norm). ``stats``, a dict, receives the layer's
    calibration statistics (JAX ``_layer_forward``'s); capture runs the adds
    and norms as torch ops and takes no fused route, so every norm output
    and projection is seen on its own, and returns (h + down, None). Under
    a mesh (``plan``, ``shard/sharding.py:tp_plan``) the layer holds its
    rank's heads and MLP columns, and o and down sum over "model"."""
    b, t, d = h.shape
    hd = cfg.head_dim
    n_q, n_kv = plan.q_heads, plan.kv_heads
    qkv_gran = qcfg.qkv if qcfg else PER_TENSOR
    capture = stats is not None
    attn, mlp = lp["attn"], lp["mlp"]
    qkv_names = ("qkv",) if "qkv" in attn else ("q", "k", "v")

    h, x = add_rms_norm(h, pending, lp["ln1"]["w"], cfg.rms_norm_eps, None if capture else
                        norm_dtype(_qkv_prescaled(qcfg, attn), [attn[n] for n in qkv_names]))
    if capture:
        stats["qkv_in_ch_absmax"] = absmax_ch(x)
    if x.dtype == torch.int8:
        # the norm wrote q|k|v's int8 input directly
        outs = [linear_prequant(x.reshape(b * t, d), attn[n], compute_dtype).reshape(b, t, -1)
                for n in qkv_names]
    else:
        # q|k|v as one GEMM where fused; its dequant_scale is a per-column vector
        outs = [linear(x, attn[n], qcfg, qkv_gran, LinearKind.POST_NORM, out_dtype=compute_dtype)
                for n in qkv_names]
    q, k, v = outs[0].split([n_q * hd, n_kv * hd, n_kv * hd], dim=-1) if len(outs) == 1 else outs
    if capture:
        for name, y in (("q", q), ("k", k), ("v", v)):
            stats[f"{name}_out_absmax"] = y.abs().amax()
    q = apply_rope(q.reshape(b, t, n_q, hd), cos, sin)
    k = plan.local_kv(apply_rope(k.reshape(b, t, n_kv, hd), cos, sin))
    v = plan.local_kv(v.reshape(b, t, n_kv, hd))

    ctx = update_and_attend(q, k, v, cache, cache_index, mask,
                            1.0 / math.sqrt(hd), compute_dtype,
                            plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts,
                            kv_window=kv_window, sliding_window=cfg.sliding_window)
    ctx = ctx.reshape(b, t, n_q * hd)
    attn_out = row_linear(ctx, attn["o"], qcfg, qcfg.out if qcfg else PER_TENSOR,
                          LinearKind.SCALED, compute_dtype, mesh if plan.attn else None)
    if capture:
        stats["o_in_ch_absmax"] = absmax_ch(ctx)
        stats["o_out_absmax"] = attn_out.abs().amax()

    inter = cfg.intermediate_size // (plan.model if plan.mlp else 1)
    if fused_block_enabled(qcfg, capture) and is_quantized(attn["o"]):
        # residual add + RMSNorm + int8 quantize in one kernel, feeding the
        # gate|up GEMM its int8 input directly
        h2, x2_q = fused_add_rmsnorm_quant(h.reshape(b * t, d),
                                           attn_out.reshape(b * t, d),
                                           lp["ln2"]["w"], eps=cfg.rms_norm_eps)
        h = h2.reshape(b, t, d)
        if "gateup" in mlp:
            proj = linear_prequant(x2_q, mlp["gateup"], compute_dtype)
            gate, up = proj.reshape(b, t, 2 * inter).split([inter, inter], -1)
        else:
            gate = linear_prequant(x2_q, mlp["gate"], compute_dtype).reshape(b, t, -1)
            up = linear_prequant(x2_q, mlp["up"], compute_dtype).reshape(b, t, -1)
    else:
        gateup_names = ("gateup",) if "gateup" in mlp else ("gate", "up")
        h, x2 = add_rms_norm(h, attn_out, lp["ln2"]["w"], cfg.rms_norm_eps, None if capture
                             else norm_dtype(False, [mlp[n] for n in gateup_names]))
        if capture:
            stats["gate_in_ch_absmax"] = absmax_ch(x2)
        fc1 = qcfg.fc1 if qcfg else PER_TENSOR
        outs = [linear(x2, mlp[n], qcfg, fc1, LinearKind.POST_NORM, out_dtype=compute_dtype)
                for n in gateup_names]
        gate, up = outs[0].split([inter, inter], dim=-1) if len(outs) == 1 else outs
    act = (activation(gate.float(), cfg.hidden_act) * up.float()).to(compute_dtype)
    down = row_linear(act, mlp["down"], qcfg, qcfg.fc2 if qcfg else PER_TENSOR,
                      LinearKind.SCALED, compute_dtype, mesh if plan.mlp else None)
    if capture:
        stats["gate_out_absmax"] = gate.abs().amax()
        stats["up_out_absmax"] = up.abs().amax()
        stats["down_in_ch_absmax"] = absmax_ch(act)
        stats["down_out_absmax"] = down.abs().amax()
        return h + down, None
    return h, down


def forward(params, input_ids: torch.Tensor, cfg: LlamaConfig,
            quant_config: Optional[QuantConfig] = None, *,
            kv_cache=None, cache_index=None,
            kv_valid: Optional[torch.Tensor] = None,
            pad_starts: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            kv_window: Optional[int] = None,
            capture_stats: bool = False,
            compute_dtype=torch.float32, mesh=None):
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
    attention. Returns (hidden [B, T, D], kv_cache), and with
    ``capture_stats`` (hidden, kv_cache, stats): {STAT_KEYS: device tensors
    stacked [L, ...]}, per-channel absmaxes [L, C] and absmax scalars [L].
    ``mesh`` (``shard/mesh.py``): params, cache and rows are this rank's
    (``shard/sharding.py``), and the layers sum their row-parallel
    projections over its "model" axis."""
    b, t = input_ids.shape
    plan = forward_plan(FAMILY, cfg, mesh, quant_config, capture_stats)
    dev = input_ids.device
    h = stage_input(lambda: embed(params, input_ids, cfg, compute_dtype), mesh,
                    (b, t, cfg.hidden_size), compute_dtype, dev)
    chunk0 = chunkN = plain_causal = False
    if kv_cache is not None:
        slots, mask, chunk0, chunkN = cache_mask_and_routing(
            kv_cache[0], cache_index, b, t, kv_valid, pad_starts,
            cfg.sliding_window, kv_window)
        if positions is None:
            positions = slots
    else:
        positions, mask, plain_causal = uncached_mask_and_positions(
            b, t, positions, attention_mask, cfg.sliding_window, dev)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    per_layer, pending = [], None
    for i, lp in enumerate(params["layers"]):
        stats = {} if capture_stats else None
        h, pending = _layer_forward(
            h, lp, cfg, quant_config, cos, sin, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index,
            compute_dtype, pending=pending, plain_causal=plain_causal, chunk0=chunk0,
            banded=chunkN, banded_starts=pad_starts, kv_window=kv_window, stats=stats,
            plan=plan, mesh=mesh)
        per_layer.append(stats)
    h = stage_output(h, lambda x, r: head(params, x, cfg, compute_dtype, pending=r), mesh,
                     pending)
    if capture_stats:
        return h, kv_cache, {k: torch.stack([st[k] for st in per_layer]) for k in STAT_KEYS}
    return h, kv_cache


def logits(params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """lm_head (float): f32 [B, T, V], the product in the weight's dtype with
    f32 accumulation (a rank's vocab slice gathered over ``mesh``'s "model"
    axis)."""
    return lm_logits(params, hidden, mesh)


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


# ---------------------------------------------------------------------------
# calibration statistics, smoothing and quantization (JAX llama.py:437-672)
# ---------------------------------------------------------------------------

# the per-layer statistics of forward(capture_stats=True); batches aggregate
# by an elementwise max. *_out_absmax covers every projection, so an fp8
# observer pass derives output scales too
STAT_KEYS = (
    "qkv_in_ch_absmax", "q_out_absmax", "k_out_absmax", "v_out_absmax",
    "o_in_ch_absmax", "o_out_absmax", "gate_in_ch_absmax", "gate_out_absmax",
    "up_out_absmax", "down_in_ch_absmax", "down_out_absmax",
)

# HF module-name suffix per projection key (fp8 ignore patterns)
HF_PROJ_NAMES = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}

# each projection's per-channel input statistic
_PROJ_INPUT = {"q": "qkv_in_ch_absmax", "k": "qkv_in_ch_absmax", "v": "qkv_in_ch_absmax",
               "o": "o_in_ch_absmax", "gate": "gate_in_ch_absmax",
               "up": "gate_in_ch_absmax", "down": "down_in_ch_absmax"}
# each projection's block in a layer's params
_GROUPS = {"q": "attn", "k": "attn", "v": "attn", "o": "attn",
           "gate": "mlp", "up": "mlp", "down": "mlp"}


def act_scales_dict(stats) -> Dict[str, torch.Tensor]:
    """Stacked statistics -> the reference's act_scales dict, keyed by HF
    module name: each projection's per-channel input absmax."""
    stats = {k: as_tensor(v) for k, v in stats.items()}
    out = {}
    for i in range(stats["qkv_in_ch_absmax"].shape[0]):
        for proj, key in _PROJ_INPUT.items():
            out[f"model.layers.{i}.{HF_PROJ_NAMES[proj]}"] = stats[key][i]
    return out


def _ch_max(stats, key) -> torch.Tensor:
    return as_tensor(stats[key]).amax(dim=-1)


def layer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-layer int8 scales [L] (absmax / 127) from stacked statistics
    (tensors or numpy arrays), on the statistics' device."""
    def div(x):
        return qmath.true_div(as_tensor(x), qmath.INT8_MAX)

    return {
        "attn_input_scale": div(_ch_max(stats, "qkv_in_ch_absmax")),
        "q_output_scale": div(stats["q_out_absmax"]),
        "k_output_scale": div(stats["k_out_absmax"]),
        "v_output_scale": div(stats["v_out_absmax"]),
        "out_input_scale": div(_ch_max(stats, "o_in_ch_absmax")),
        "gate_input_scale": div(_ch_max(stats, "gate_in_ch_absmax")),
        "down_input_scale": div(_ch_max(stats, "down_in_ch_absmax")),
    }


def fp8_observer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-projection fp8 input and output scales [L] (absmax / 448) from
    an observer pass through the fp8-quantized model."""
    return fp8_observer_scales_of(stats, _PROJ_INPUT)


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def smooth(params, stats, alpha: float = 0.5, cfg: Optional[LlamaConfig] = None):
    """SmoothQuant migration of every layer (the reference's smooth_lm for
    Llama): ln1 -> q, k, v by the qkv input statistics; ln2 -> gate, up by
    the gate input statistics. ``stats`` may be host or device tensors or
    numpy arrays; the new params share every leaf the migration leaves."""
    from ..quant.smooth import smooth_norm_fcs

    st = scales_on({k: stats[k] for k in ("qkv_in_ch_absmax", "gate_in_ch_absmax")},
                   _device(params))
    layers = []
    for i, lp in enumerate(params["layers"]):
        attn, mlp = lp["attn"], lp["mlp"]
        ln1, (q, k, v), _ = smooth_norm_fcs(
            lp["ln1"]["w"], [attn[n]["w"] for n in ("q", "k", "v")],
            st["qkv_in_ch_absmax"][i], alpha)
        ln2, (gate, up), _ = smooth_norm_fcs(
            lp["ln2"]["w"], [mlp["gate"]["w"], mlp["up"]["w"]],
            st["gate_in_ch_absmax"][i], alpha)
        layers.append({
            **lp, "ln1": {"w": ln1}, "ln2": {"w": ln2},
            "attn": {**attn, **{n: {**attn[n], "w": w}
                                for n, w in (("q", q), ("k", k), ("v", v))}},
            "mlp": {**mlp, "gate": {**mlp["gate"], "w": gate},
                    "up": {**mlp["up"], "w": up}}})
    return {**params, "layers": layers}


def quantize(params, qcfg: QuantConfig, scales=None,
             cfg: Optional[LlamaConfig] = None, *, ignore=frozenset(),
             quantize_output: bool = False, observer_scales=None):
    """The quantized params of float ``params`` (the reference's
    from_float_to_int8 / _to_fp8), in the port's layout: [out, in] weights,
    unfused q, k, v and gate, up (``Engine`` fuses at load), on the params'
    device. ``scales``: ``layer_scales`` output, needed by int8 and, without
    ``observer_scales``, by fp8 static.

    int8 folds each per-tensor input scale of q|k|v and gate|up into ln1 and
    ln2; int4 packs grouped weights and leaves the norms; fp8 keeps the
    projections in ``ignore`` (keys of HF_PROJ_NAMES) float, and for e4m3
    static adds input scales (and output scales with ``quantize_output``)
    from ``observer_scales`` (``fp8_observer_scales`` of an observer pass)."""
    layers = params["layers"]
    if qcfg.is_int4:
        new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
                "attn": {k: pack_int4(v, qcfg.group_size) for k, v in lp["attn"].items()},
                "mlp": {k: pack_int4(v, qcfg.group_size) for k, v in lp["mlp"].items()}}
               for lp in layers]
        return {**params, "layers": new}
    if qcfg.is_int8:
        if scales is None:
            raise ValueError("int8 quantization needs layer_scales")
        sc = scales_on(scales, _device(params))

        def pack(p, s, gran, kind):
            return pack_int8(p, s, gran, kind, p.get("bias"))

        new = []
        for i, lp in enumerate(layers):
            attn_in, out_in = sc["attn_input_scale"][i], sc["out_input_scale"][i]
            gate_in, down_in = sc["gate_input_scale"][i], sc["down_input_scale"][i]
            attn, mlp = lp["attn"], lp["mlp"]
            new.append({
                "ln1": {"w": lp["ln1"]["w"] / attn_in if qcfg.qkv == PER_TENSOR
                        else lp["ln1"]["w"]},
                "attn": {**{n: pack(attn[n], attn_in, qcfg.qkv, LinearKind.POST_NORM)
                            for n in ("q", "k", "v")},
                         "o": pack(attn["o"], out_in, qcfg.out, LinearKind.SCALED)},
                "ln2": {"w": lp["ln2"]["w"] / gate_in if qcfg.fc1 == PER_TENSOR
                        else lp["ln2"]["w"]},
                "mlp": {**{n: pack(mlp[n], gate_in, qcfg.fc1, LinearKind.POST_NORM)
                           for n in ("gate", "up")},
                        "down": pack(mlp["down"], down_in, qcfg.fc2, LinearKind.SCALED)}})
        return {**params, "layers": new}

    def fp8(key, p):
        return dict(p) if key in ignore else pack_fp8(p, qcfg, p.get("bias"))

    new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
            "attn": {k: fp8(k, v) for k, v in lp["attn"].items()},
            "mlp": {k: fp8(k, v) for k, v in lp["mlp"].items()}} for lp in layers]
    if qcfg.type == "fp8_e4m3" and qcfg.activation_scheme == "static":
        legacy = {"q": "attn_input_scale", "k": "attn_input_scale", "v": "attn_input_scale",
                  "o": "out_input_scale", "gate": "gate_input_scale",
                  "up": "gate_input_scale", "down": "down_input_scale"}
        add_static_fp8_scales(new, qcfg, scales, _GROUPS, legacy, ignore=ignore,
                              quantize_output=quantize_output,
                              observer_scales=observer_scales)
    return {**params, "layers": new}
