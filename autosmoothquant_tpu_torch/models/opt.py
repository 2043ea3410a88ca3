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

The quantize path (JAX ``opt.py:245-329``, ``:373-580``): ``forward(...,
capture_stats=True)`` returns the calibration statistics too (fc1's output
absmax read before the ReLU); ``smooth`` (a pre-LN model only: in a post-LN
one the LayerNorms do not feed the projections), ``layer_scales``,
``fp8_observer_scales`` and ``quantize``, as for Llama. Not ported: the mesh
hints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..kernels.fused import fused_add_layernorm_quant
from ..quant import math as qmath
from ..quant.config import PER_TENSOR, QuantConfig
from ..runtime import resolve_device
from .common import (
    LinearKind,
    absmax_ch,
    add_static_fp8_scales,
    as_tensor,
    cache_mask_and_routing,
    complete,
    forward_plan,
    fp8_observer_scales_of,
    fused_block_enabled,
    layer_norm,
    linear,
    linear_prequant,
    lm_logits,
    make_kv_cache,
    pack_fp8,
    pack_int4,
    pack_int8,
    row_linear,
    scales_on,
    stage_input,
    stage_output,
    uncached_mask_and_positions,
    update_and_attend,
)

FAMILY = "transformers"  # the reference's family tag for OPT (its models/__init__.py)
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
                   chunk0=False, banded=False, banded_starts=None, kv_window=None,
                   stats=None, plan=None, mesh=None):
    """One decoder layer; h: [B, T, D] in compute_dtype. The cache (if any)
    is written in place. ``stats``, a dict, receives the layer's calibration
    statistics (capture takes no fused route). Under a mesh (``plan``) the
    layer holds its rank's heads and fc1 columns; o and fc2 sum over
    "model"."""
    b, t, d = h.shape
    hd, n_h = cfg.head_dim, plan.q_heads
    attn_mesh, mlp_mesh = (mesh if plan.attn else None), (mesh if plan.mlp else None)
    eps = cfg.layer_norm_eps
    pre_ln = cfg.do_layer_norm_before
    capture = stats is not None

    # attention. Post-LN (opt-350m): the q/k/v input is no norm output, so its
    # per-tensor scale cannot be folded; it lives in quant_scale (SCALED)
    residual = h
    if pre_ln:
        x, qkv_kind = layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], eps), LinearKind.POST_NORM
    else:
        x, qkv_kind = h.float(), LinearKind.SCALED
    gran = qcfg.qkv if qcfg else PER_TENSOR
    q, k, v = (linear(x, lp["attn"][name], qcfg, gran, qkv_kind, out_dtype=compute_dtype)
               for name in ("q", "k", "v"))
    if capture:
        stats["qkv_in_ch_absmax"] = absmax_ch(x)
        for name, y in (("q", q), ("k", k), ("v", v)):
            stats[f"{name}_out_absmax"] = y.abs().amax()
    ctx = update_and_attend(q.reshape(b, t, n_h, hd), k.reshape(b, t, n_h, hd),
                            v.reshape(b, t, n_h, hd), cache, cache_index, mask,
                            1.0 / math.sqrt(hd), compute_dtype,
                            plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts,
                            kv_window=kv_window).reshape(b, t, n_h * hd)
    attn_out = row_linear(ctx, lp["attn"]["o"], qcfg, qcfg.out if qcfg else PER_TENSOR,
                          LinearKind.SCALED, compute_dtype, attn_mesh)
    if capture:
        stats["o_in_ch_absmax"] = absmax_ch(ctx)
        stats["o_out_absmax"] = attn_out.abs().amax()
    fc2_gran = qcfg.fc2 if qcfg else PER_TENSOR

    if pre_ln and fused_block_enabled(qcfg, capture):
        # residual add + ln2 + int8 quantize in one kernel, feeding fc1 its
        # int8 input; ReLU in fc1's epilogue
        h2, x2_q = fused_add_layernorm_quant(
            residual.reshape(b * t, d), attn_out.reshape(b * t, d),
            lp["ln2"]["w"], lp["ln2"]["b"], eps=eps)
        h = h2.reshape(b, t, d)
        act = linear_prequant(x2_q, lp["mlp"]["fc1"], compute_dtype,
                              activation="relu").reshape(b, t, -1)
        out = row_linear(act, lp["mlp"]["fc2"], qcfg, fc2_gran, LinearKind.SCALED,
                         compute_dtype, mlp_mesh)
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
    if capture:  # before the ReLU: the projection's own output
        stats["fc1_in_ch_absmax"] = absmax_ch(x2)
        stats["fc1_out_absmax"] = act.abs().amax()
    act = torch.clamp_min(act, 0)
    out = row_linear(act, lp["mlp"]["fc2"], qcfg, fc2_gran, LinearKind.SCALED,
                     compute_dtype, mlp_mesh)
    if capture:
        stats["fc2_in_ch_absmax"] = absmax_ch(act)
        stats["fc2_out_absmax"] = out.abs().amax()
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
            capture_stats: bool = False,
            compute_dtype=torch.float32, mesh=None):
    """Run the decoder stack (HF OPTDecoder.forward). input_ids: int [B, T].

    Arguments as ``models/llama.py:forward``: kv_cache None or the list from
    ``init_kv_cache``, written in place at [cache_index, cache_index + T)
    (cache_index scalar or per row); kv_valid bool [B, S_max] (decode);
    pad_starts int32 [B] (ragged prefill); positions int [B, T] index the
    learned position table at ``positions + POS_OFFSET``; kv_window bounds
    the cache columns decode attention reads. Returns (hidden [B, T, Dw],
    kv_cache), and with ``capture_stats`` (hidden, kv_cache, stats), the
    statistics stacked [L, ...] under ``STAT_KEYS``. ``mesh``: a rank's
    params, cache and rows (``models/llama.py:forward``)."""
    b, t = input_ids.shape
    plan = forward_plan(FAMILY, cfg, mesh, quant_config, capture_stats)
    dev = input_ids.device
    chunk0 = chunkN = plain_causal = False
    if kv_cache is not None:
        slots, mask, chunk0, chunkN = cache_mask_and_routing(
            kv_cache[0], cache_index, b, t, kv_valid, pad_starts, 0, kv_window)
        if positions is None:
            positions = slots  # no padding: the slot is the position
    else:
        positions, mask, plain_causal = uncached_mask_and_positions(
            b, t, positions, attention_mask, 0, dev)
    h = stage_input(lambda: embed(params, input_ids, cfg, compute_dtype, positions), mesh,
                    (b, t, cfg.hidden_size), compute_dtype, dev)
    per_layer = []
    for i, lp in enumerate(params["layers"]):
        stats = {} if capture_stats else None
        h = _layer_forward(
            h, lp, cfg, quant_config, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index,
            compute_dtype, plain_causal=plain_causal, chunk0=chunk0,
            banded=chunkN, banded_starts=pad_starts, kv_window=kv_window, stats=stats,
            plan=plan, mesh=mesh)
        per_layer.append(stats)
    h = stage_output(h, lambda x, r: head(params, x, cfg, compute_dtype, pending=r), mesh)
    if capture_stats:
        return h, kv_cache, {k: torch.stack([st[k] for st in per_layer]) for k in STAT_KEYS}
    return h, kv_cache


def embed(params, input_ids: torch.Tensor, cfg, compute_dtype, positions=None
          ) -> torch.Tensor:
    """The first stage's input [B, T, D]: the token embedding, through
    ``project_in`` where the model has one, plus the learned positions
    (``positions`` [B, T]; default 0..T-1) at ``positions + POS_OFFSET``."""
    h = params["embed"]["w"][input_ids].to(compute_dtype)
    if "project_in" in params:
        h = h @ params["project_in"]["w"].to(compute_dtype)
    if positions is None:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return h + params["embed_pos"]["w"][positions.long() + POS_OFFSET].to(compute_dtype)


def head(params, h: torch.Tensor, cfg, compute_dtype, pending=None) -> torch.Tensor:
    """The last stage's output: the final LayerNorm (pre-LN models), the
    cast to compute_dtype and ``project_out`` where the model has one.
    ``pending``: a branch output not yet added to h, as the other families'
    heads take it (OPT's layers leave none: None)."""
    h = complete(h, pending)
    if cfg.do_layer_norm_before and "final_norm" in params:
        h = layer_norm(h, params["final_norm"]["w"], params["final_norm"]["b"],
                       cfg.layer_norm_eps)
    h = h.to(compute_dtype)
    if "project_out" in params:
        h = h @ params["project_out"]["w"].to(compute_dtype)
    return h


def logits(params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """lm_head (float): f32 [B, T, V], the product in the weight's dtype with
    f32 accumulation (a rank's vocab slice gathered over ``mesh``)."""
    return lm_logits(params, hidden, mesh)


def init_kv_cache(cfg: OPTConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """dtype torch.int8 selects the int8 cache (values + per-token-per-head
    scales)."""
    return make_kv_cache(cfg.num_hidden_layers, batch, max_len,
                         cfg.num_attention_heads, cfg.head_dim, dtype,
                         resolve_device(device))


# ---------------------------------------------------------------------------
# calibration statistics, smoothing and quantization (JAX opt.py:373-580)
# ---------------------------------------------------------------------------

STAT_KEYS = (
    "qkv_in_ch_absmax", "q_out_absmax", "k_out_absmax", "v_out_absmax",
    "o_in_ch_absmax", "o_out_absmax", "fc1_in_ch_absmax", "fc1_out_absmax",
    "fc2_in_ch_absmax", "fc2_out_absmax",
)

# HF module-name suffix per projection key and OPT's layer path (fp8 ignore
# patterns)
HF_PROJ_NAMES = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.out_proj", "fc1": "fc1", "fc2": "fc2",
}
HF_LAYER_FMT = "model.decoder.layers.{i}"

_PROJ_INPUT = {"q": "qkv_in_ch_absmax", "k": "qkv_in_ch_absmax", "v": "qkv_in_ch_absmax",
               "o": "o_in_ch_absmax", "fc1": "fc1_in_ch_absmax", "fc2": "fc2_in_ch_absmax"}
_GROUPS = {"q": "attn", "k": "attn", "v": "attn", "o": "attn", "fc1": "mlp", "fc2": "mlp"}


def act_scales_dict(stats) -> Dict[str, torch.Tensor]:
    """Stacked statistics -> the reference's act_scales dict, keyed by HF
    module name."""
    stats = {k: as_tensor(v) for k, v in stats.items()}
    out = {}
    for i in range(stats["qkv_in_ch_absmax"].shape[0]):
        for proj, key in _PROJ_INPUT.items():
            out[f"{HF_LAYER_FMT.format(i=i)}.{HF_PROJ_NAMES[proj]}"] = stats[key][i]
    return out


def _ch_max(stats, key) -> torch.Tensor:
    return as_tensor(stats[key]).amax(dim=-1)


def layer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-layer int8 scales [L] (absmax / 127), on the statistics' device."""
    def div(x):
        return qmath.true_div(as_tensor(x), qmath.INT8_MAX)

    return {
        "attn_input_scale": div(_ch_max(stats, "qkv_in_ch_absmax")),
        "q_output_scale": div(stats["q_out_absmax"]),
        "k_output_scale": div(stats["k_out_absmax"]),
        "v_output_scale": div(stats["v_out_absmax"]),
        "out_input_scale": div(_ch_max(stats, "o_in_ch_absmax")),
        "fc1_input_scale": div(_ch_max(stats, "fc1_in_ch_absmax")),
        "fc2_input_scale": div(_ch_max(stats, "fc2_in_ch_absmax")),
    }


def fp8_observer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-projection fp8 input and output scales [L] (absmax / 448) from
    an observer pass through the fp8-quantized model."""
    return fp8_observer_scales_of(stats, _PROJ_INPUT)


def smooth(params, stats, alpha: float = 0.5, cfg: Optional[OPTConfig] = None):
    """The reference's smooth_lm for OPT: ln1 -> q, k, v and ln2 -> fc1,
    each LayerNorm's bias divided too. A post-LN model (``cfg`` with
    do_layer_norm_before False) is returned as it is: its LayerNorms do not
    feed the projections, so the migration would change the function (the
    reference applies it anyway; the JAX package skips it too)."""
    from ..quant.smooth import smooth_norm_fcs

    if cfg is not None and not cfg.do_layer_norm_before:
        return params
    st = scales_on({k: stats[k] for k in ("qkv_in_ch_absmax", "fc1_in_ch_absmax")},
                   params["embed"]["w"].device)
    layers = []
    for i, lp in enumerate(params["layers"]):
        attn, mlp = lp["attn"], lp["mlp"]
        ln1w, (q, k, v), ln1b = smooth_norm_fcs(
            lp["ln1"]["w"], [attn[n]["w"] for n in ("q", "k", "v")],
            st["qkv_in_ch_absmax"][i], alpha, norm_bias=lp["ln1"]["b"])
        ln2w, (fc1,), ln2b = smooth_norm_fcs(
            lp["ln2"]["w"], [mlp["fc1"]["w"]], st["fc1_in_ch_absmax"][i], alpha,
            norm_bias=lp["ln2"]["b"])
        layers.append({
            **lp, "ln1": {"w": ln1w, "b": ln1b}, "ln2": {"w": ln2w, "b": ln2b},
            "attn": {**attn, **{n: {**attn[n], "w": w}
                                for n, w in (("q", q), ("k", k), ("v", v))}},
            "mlp": {**mlp, "fc1": {**mlp["fc1"], "w": fc1}}})
    return {**params, "layers": layers}


def quantize(params, qcfg: QuantConfig, scales=None, cfg: Optional[OPTConfig] = None, *,
             ignore=frozenset(), quantize_output: bool = False, observer_scales=None):
    """The quantized params of float OPT ``params`` (the reference's
    Int8OPTForCausalLM.from_float, and the fp8 and int4 formats family-wide
    as in the JAX package): [out, in] weights with f32 biases, on the params'
    device. int8 folds the per-tensor q|k|v and fc1 input scales into ln1 and
    ln2 (weight and bias) of a pre-LN model; a post-LN model's q|k|v and fc1
    quantize their inputs with a static quant_scale instead. ``scales``,
    ``ignore``, ``quantize_output`` and ``observer_scales`` as for Llama."""
    layers = params["layers"]

    def f32_bias(p):
        return {**p, "bias": p["bias"].float()}

    if qcfg.is_int4:
        new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
                "attn": {k: pack_int4(f32_bias(v), qcfg.group_size)
                         for k, v in lp["attn"].items()},
                "mlp": {k: pack_int4(f32_bias(v), qcfg.group_size)
                        for k, v in lp["mlp"].items()}} for lp in layers]
        return {**params, "layers": new}
    if not qcfg.is_int8:
        def fp8(key, p):
            return dict(p) if key in ignore else pack_fp8(p, qcfg, p["bias"].float())

        new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
                "attn": {k: fp8(k, v) for k, v in lp["attn"].items()},
                "mlp": {k: fp8(k, v) for k, v in lp["mlp"].items()}} for lp in layers]
        if qcfg.type == "fp8_e4m3" and qcfg.activation_scheme == "static":
            legacy = {"q": "attn_input_scale", "k": "attn_input_scale",
                      "v": "attn_input_scale", "o": "out_input_scale",
                      "fc1": "fc1_input_scale", "fc2": "fc2_input_scale"}
            add_static_fp8_scales(new, qcfg, scales, _GROUPS, legacy, ignore=ignore,
                                  quantize_output=quantize_output,
                                  observer_scales=observer_scales)
        return {**params, "layers": new}
    if scales is None:
        raise ValueError("int8 quantization needs layer_scales")
    pre_ln = cfg.do_layer_norm_before if cfg is not None else True
    qkv_kind = LinearKind.POST_NORM if pre_ln else LinearKind.SCALED
    sc = scales_on(scales, params["embed"]["w"].device)

    def fold(ln, s, enable):
        return {"w": ln["w"] / s, "b": ln["b"] / s} if enable else dict(ln)

    def pack(p, s, gran, kind):
        return pack_int8(p, s, gran, kind, p["bias"].float())

    new = []
    for i, lp in enumerate(layers):
        attn_in, out_in = sc["attn_input_scale"][i], sc["out_input_scale"][i]
        fc1_in, fc2_in = sc["fc1_input_scale"][i], sc["fc2_input_scale"][i]
        attn, mlp = lp["attn"], lp["mlp"]
        new.append({
            "ln1": fold(lp["ln1"], attn_in, pre_ln and qcfg.qkv == PER_TENSOR),
            "attn": {**{n: pack(attn[n], attn_in, qcfg.qkv, qkv_kind) for n in ("q", "k", "v")},
                     "o": pack(attn["o"], out_in, qcfg.out, LinearKind.SCALED)},
            "ln2": fold(lp["ln2"], fc1_in, pre_ln and qcfg.fc1 == PER_TENSOR),
            "mlp": {"fc1": pack(mlp["fc1"], fc1_in, qcfg.fc1, qkv_kind),
                    "fc2": pack(mlp["fc2"], fc2_in, qcfg.fc2, LinearKind.SCALED)}})
    return {**params, "layers": new}
