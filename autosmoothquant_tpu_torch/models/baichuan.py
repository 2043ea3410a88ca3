"""Baichuan family (7B: RoPE; 13B and Baichuan-2-13B: ALiBi; the fused W_pack
q|k|v; the NormHead lm_head): the port of
``autosmoothquant_tpu/models/baichuan.py``.

Params (``convert/hf.py:baichuan_params_from_state_dict``,
``convert/from_jax.py``):
    {"embed":      {"w": [V, D]},
     "layers":     [{"ln1": {"w": f32 [D]},
                     "attn": {"wpack": proj [D -> 3D], "o": proj},
                     "ln2": {"w": f32 [D]},
                     "mlp": {"gate", "up", "down"}}, ...],
     "final_norm": {"w": f32 [D]},
     "lm_head":    {"w": [D, V]}}      # NormHead: columns L2-normalized at load
A projection is as in ``models/llama.py``. W_pack quantized keeps one GEMM:
int8 with a [3D] dequant vector (a per-section weight scale, times the
per-tensor input scale), fp8 e4m3 with a [3D] ``w_scale``, int4 with its
[3D, G] group scales.

What the reference keeps (JAX module's docstring): the position embedding
follows hidden_size (4096: RoPE, else ALiBi); ALiBi's bias m_h * (k - q)
enters as m_h * (key slot) by the softmax's shift invariance, and every
attention route of the port takes the slopes (``kernels/attention.py``):
K3 in prefill, decode attention in a decode step, contiguous or paged (the
logical key position). Heads are not grouped (Hq = Hkv).

Per layer, as JAX: RMSNorm -> W_pack -> (RoPE) -> attention -> o_proj ->
residual -> RMSNorm -> gate, up -> silu(gate) * up -> down -> residual. Each
norm before a per-tensor int8 projection runs as one RMSNorm + int8 kernel a
row (``kernels/fused.py:rmsnorm_quant``: the two ops JAX runs, rms_norm then
the prescaled quantize), the final norm through the same kernel unquantized,
as in ``models/llama.py``. The residual add stays apart (JAX adds before
its second norm; the fused add + norm + int8 kernel K2 is Llama's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.fused import rmsnorm_quant
from ..quant import math as qmath
from ..quant.config import PER_TENSOR, QuantConfig
from ..runtime import resolve_device
from .common import (
    LinearKind,
    absmax_ch,
    add_static_fp8_scales,
    apply_rope,
    as_tensor,
    cache_mask_and_routing,
    forward_plan,
    linear,
    linear_prequant,
    lm_logits,
    make_kv_cache,
    pack_fp8,
    pack_int4,
    pack_int8,
    rms_norm,
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

FAMILY = "baichuan"


@dataclasses.dataclass(frozen=True)
class BaichuanConfig:
    vocab_size: int = 64000
    hidden_size: int = 5120
    intermediate_size: int = 13696
    num_hidden_layers: int = 40
    num_attention_heads: int = 40
    model_max_length: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # "ROPE" or "ALIBI" for tests and small models; None: by hidden_size
    force_position_embedding: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def position_embedding(self) -> str:
        """7B (hidden 4096) takes RoPE, the 13B models ALiBi."""
        if self.force_position_embedding is not None:
            return self.force_position_embedding
        return "ROPE" if self.hidden_size == 4096 else "ALIBI"

    @property
    def max_position_embeddings(self) -> int:
        return self.model_max_length

    @classmethod
    def from_hf(cls, hf) -> "BaichuanConfig":
        g = ((lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict)
             else (lambda k, d=None: getattr(hf, k, d)))
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            model_max_length=g("model_max_length", 4096),
            rms_norm_eps=g("rms_norm_eps", 1e-6),
        )


config_from_hf = BaichuanConfig.from_hf


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """The ALiBi slopes m_h, f32 [n_heads] on the CPU: the interleave
    formula of the reference (a power of 2 of heads: start * start^i;
    otherwise the closest power's, then every other one of twice its)."""
    def pow2_slopes(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(s, dtype=torch.float32)


# the slopes on each device, made once (outside any graph capture: the
# engines' first forward is eager) and reused by every later step
_SLOPES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def slopes_on(cfg: BaichuanConfig, device) -> Optional[torch.Tensor]:
    """The model's ALiBi slopes on ``device``, or None (RoPE)."""
    if cfg.position_embedding != "ALIBI":
        return None
    key = (cfg.num_attention_heads, torch.device(device))
    if key not in _SLOPES:
        _SLOPES[key] = alibi_slopes(cfg.num_attention_heads).to(device)
    return _SLOPES[key]


def init_params(cfg: BaichuanConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random float params from a seeded ``torch.Generator`` (JAX
    ``init_params``'s scales: N(0, 1/K) projections, N(0, 0.02^2) embedding
    and lm_head, unit norms; the lm_head's columns L2-normalized)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(k, n, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(k)
        return (torch.randn(k, n, generator=g, device=dev) * s).to(dtype)

    def ones():
        return {"w": torch.ones(D, dtype=torch.float32, device=dev)}

    lm = w(D, V, scale=0.02).float()
    lm = (lm / torch.linalg.vector_norm(lm, dim=0, keepdim=True)).to(dtype)
    layers = [{"ln1": ones(),
               "attn": {"wpack": {"w": w(D, 3 * D)}, "o": {"w": w(D, D)}},
               "ln2": ones(),
               "mlp": {"gate": {"w": w(D, I)}, "up": {"w": w(D, I)},
                       "down": {"w": w(I, D)}}}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": {"w": w(V, D, scale=0.02)}, "layers": layers,
            "final_norm": ones(), "lm_head": {"w": lm}}


def _prescaled(qcfg: Optional[QuantConfig], gran: Optional[str], p) -> bool:
    """Whether a projection after a norm takes per-tensor int8 whose input
    scale is folded into the norm: the norm then runs as the RMSNorm + int8
    kernel, whose sums a row's bits alone set (the batch-invariant decode
    step the continuous engines rely on)."""
    return (qcfg is not None and qcfg.is_int8 and gran == PER_TENSOR
            and p["w"].dtype == torch.int8)


def _layer_forward(h, lp, cfg: BaichuanConfig, qcfg: Optional[QuantConfig], cos, sin,
                   mask, cache, cache_index, compute_dtype, slopes, *,
                   plain_causal=False, chunk0=False, banded=False, banded_starts=None,
                   kv_window=None, stats=None, plan=None, mesh=None):
    """One decoder layer; h: [B, T, D] in compute_dtype. The cache (if any)
    is written in place; ``stats``, a dict, receives the layer's calibration
    statistics (JAX ``_layer_forward``'s). Under a mesh (``plan``) W_pack
    holds the rank's q | k | v sections and ``slopes`` its heads' slopes; o
    and down sum over "model"."""
    b, t, d = h.shape
    hd, n_h = cfg.head_dim, plan.q_heads
    capture = stats is not None
    wpack = lp["attn"]["wpack"]
    if not capture and _prescaled(qcfg, qcfg and qcfg.qkv, wpack):
        x_q = rmsnorm_quant(h.reshape(b * t, d), lp["ln1"]["w"], eps=cfg.rms_norm_eps)
        proj = linear_prequant(x_q, wpack, compute_dtype).reshape(b, t, -1)
    else:
        x = rms_norm(h, lp["ln1"]["w"], cfg.rms_norm_eps)
        if capture:
            stats["qkv_in_ch_absmax"] = absmax_ch(x)
        proj = linear(x, wpack, qcfg, qcfg.qkv if qcfg else PER_TENSOR,
                      LinearKind.POST_NORM, out_dtype=compute_dtype)
    if capture:
        stats["attn_out_absmax"] = proj.abs().amax()
    q, k, v = (y.reshape(b, t, n_h, hd) for y in proj.split(n_h * hd, dim=-1))
    if cos is not None:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    else:
        q = q.contiguous()  # a view into W_pack's output; decode attention reads rows

    ctx = update_and_attend(q, k, v, cache, cache_index, mask, 1.0 / math.sqrt(hd),
                            compute_dtype, plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts, kv_window=kv_window,
                            alibi_slopes=slopes)
    ctx = ctx.reshape(b, t, n_h * hd)
    attn_out = row_linear(ctx, lp["attn"]["o"], qcfg, qcfg.out if qcfg else PER_TENSOR,
                          LinearKind.SCALED, compute_dtype, mesh if plan.attn else None)
    if capture:
        stats["o_in_ch_absmax"] = absmax_ch(ctx)
        stats["o_out_absmax"] = attn_out.abs().amax()
    h = h + attn_out

    mlp = lp["mlp"]
    fc1 = qcfg.fc1 if qcfg else PER_TENSOR
    if not capture and _prescaled(qcfg, fc1, mlp["gate"]) and _prescaled(qcfg, fc1, mlp["up"]):
        x2_q = rmsnorm_quant(h.reshape(b * t, d), lp["ln2"]["w"], eps=cfg.rms_norm_eps)
        gate, up = (linear_prequant(x2_q, mlp[n], compute_dtype).reshape(b, t, -1)
                    for n in ("gate", "up"))
    else:
        x2 = rms_norm(h, lp["ln2"]["w"], cfg.rms_norm_eps)
        if capture:
            stats["gate_in_ch_absmax"] = absmax_ch(x2)
        gate = linear(x2, mlp["gate"], qcfg, fc1, LinearKind.POST_NORM, out_dtype=compute_dtype)
        up = linear(x2, mlp["up"], qcfg, fc1, LinearKind.POST_NORM, out_dtype=compute_dtype)
    act = (torch.nn.functional.silu(gate.float()) * up.float()).to(compute_dtype)
    down = row_linear(act, lp["mlp"]["down"], qcfg, qcfg.fc2 if qcfg else PER_TENSOR,
                      LinearKind.SCALED, compute_dtype, mesh if plan.mlp else None)
    if capture:
        stats["gate_out_absmax"] = gate.abs().amax()
        stats["up_out_absmax"] = up.abs().amax()
        stats["down_in_ch_absmax"] = absmax_ch(act)
        stats["down_out_absmax"] = down.abs().amax()
    return h + down


def forward(params, input_ids: torch.Tensor, cfg: BaichuanConfig,
            quant_config: Optional[QuantConfig] = None, *,
            kv_cache=None, cache_index=None,
            kv_valid: Optional[torch.Tensor] = None,
            pad_starts: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            kv_window: Optional[int] = None,
            capture_stats: bool = False,
            compute_dtype=torch.float32, mesh=None):
    """Run the decoder stack: the arguments and results of
    ``models/llama.py:forward`` (contiguous, paged or a verify's rows; with
    ``capture_stats`` the statistics under ``STAT_KEYS`` too; ``mesh``: a
    rank's params, cache and rows)."""
    b, t = input_ids.shape
    plan = forward_plan(FAMILY, cfg, mesh, quant_config, capture_stats)
    dev = input_ids.device
    h = stage_input(lambda: embed(params, input_ids, cfg, compute_dtype), mesh,
                    (b, t, cfg.hidden_size), compute_dtype, dev)
    chunk0 = chunkN = plain_causal = False
    if kv_cache is not None:
        slots, mask, chunk0, chunkN = cache_mask_and_routing(
            kv_cache[0], cache_index, b, t, kv_valid, pad_starts, 0, kv_window)
        if positions is None:
            positions = slots
    else:
        positions, mask, plain_causal = uncached_mask_and_positions(
            b, t, positions, attention_mask, 0, dev)
    cos = sin = None
    if cfg.position_embedding == "ROPE":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    slopes = plan.slopes(slopes_on(cfg, dev))
    per_layer = []
    for i, lp in enumerate(params["layers"]):
        stats = {} if capture_stats else None
        h = _layer_forward(
            h, lp, cfg, quant_config, cos, sin, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index, compute_dtype,
            slopes, plain_causal=plain_causal, chunk0=chunk0, banded=chunkN,
            banded_starts=pad_starts, kv_window=kv_window, stats=stats, plan=plan, mesh=mesh)
        per_layer.append(stats)
    h = stage_output(h, lambda x: head(params, x, cfg, compute_dtype), mesh)
    if capture_stats:
        return h, kv_cache, {k: torch.stack([st[k] for st in per_layer]) for k in STAT_KEYS}
    return h, kv_cache


def logits(params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """The NormHead lm_head (normalized at load), float: f32 [B, T, V] (a
    rank's vocab slice gathered over ``mesh``)."""
    return lm_logits(params, hidden, mesh)


def init_kv_cache(cfg: BaichuanConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """dtype torch.int8 selects the int8 cache (values + per-token-per-head
    scales)."""
    return make_kv_cache(cfg.num_hidden_layers, batch, max_len, cfg.num_attention_heads,
                         cfg.head_dim, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# calibration statistics, smoothing and quantization (JAX baichuan.py:336-604)
# ---------------------------------------------------------------------------

STAT_KEYS = (
    "qkv_in_ch_absmax", "attn_out_absmax", "o_in_ch_absmax", "o_out_absmax",
    "gate_in_ch_absmax", "gate_out_absmax", "up_out_absmax",
    "down_in_ch_absmax", "down_out_absmax",
)

# HF module-name suffix per projection key (fp8 ignore patterns)
HF_PROJ_NAMES = {
    "wpack": "self_attn.W_pack", "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
}
# each projection's per-channel input statistic, its output statistic and
# its block in a layer's params
_PROJ_INPUT = {"wpack": "qkv_in_ch_absmax", "o": "o_in_ch_absmax",
               "gate": "gate_in_ch_absmax", "up": "gate_in_ch_absmax",
               "down": "down_in_ch_absmax"}
_PROJ_OUTPUT = {"wpack": "attn_out_absmax", "o": "o_out_absmax",
                "gate": "gate_out_absmax", "up": "up_out_absmax",
                "down": "down_out_absmax"}
_GROUPS = {"wpack": "attn", "o": "attn", "gate": "mlp", "up": "mlp", "down": "mlp"}


def act_scales_dict(stats) -> Dict[str, torch.Tensor]:
    """Stacked statistics -> the reference's act_scales dict (HF module
    names: each projection's per-channel input absmax)."""
    stats = {k: as_tensor(v) for k, v in stats.items()}
    out = {}
    for i in range(stats["qkv_in_ch_absmax"].shape[0]):
        for proj, key in _PROJ_INPUT.items():
            out[f"model.layers.{i}.{HF_PROJ_NAMES[proj]}"] = stats[key][i]
    return out


def layer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-layer int8 scales [L] (absmax / 127), the reference's
    collect_baichuan_layer_scales."""
    def div(x):
        return qmath.true_div(as_tensor(x), qmath.INT8_MAX)

    def ch(key):
        return as_tensor(stats[key]).amax(dim=-1)

    return {
        "attn_input_scale": div(ch("qkv_in_ch_absmax")),
        "attn_output_scale": div(stats["attn_out_absmax"]),
        "out_input_scale": div(ch("o_in_ch_absmax")),
        "gate_input_scale": div(ch("gate_in_ch_absmax")),
        "down_input_scale": div(ch("down_in_ch_absmax")),
    }


def fp8_observer_scales(stats) -> Dict[str, torch.Tensor]:
    """Per-projection fp8 input and output scales [L] (absmax / 448); W_pack's
    output scale is the fused projection's output absmax."""
    out = {}
    for proj, key in _PROJ_INPUT.items():
        out[f"{proj}_input_scale"] = qmath.true_div(as_tensor(stats[key]).amax(dim=-1),
                                                    qmath.FP8_E4M3_MAX)
        out[f"{proj}_output_scale"] = qmath.true_div(as_tensor(stats[_PROJ_OUTPUT[proj]]),
                                                     qmath.FP8_E4M3_MAX)
    return out


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def smooth(params, stats, alpha: float = 0.5, cfg: Optional[BaichuanConfig] = None):
    """The reference's smooth_lm Baichuan branch: ln1 -> W_pack by the qkv
    input statistics; ln2 -> gate, up by the gate input statistics."""
    from ..quant.smooth import smooth_norm_fcs

    st = scales_on({k: stats[k] for k in ("qkv_in_ch_absmax", "gate_in_ch_absmax")},
                   _device(params))
    layers = []
    for i, lp in enumerate(params["layers"]):
        attn, mlp = lp["attn"], lp["mlp"]
        ln1, (wp,), _ = smooth_norm_fcs(lp["ln1"]["w"], [attn["wpack"]["w"]],
                                        st["qkv_in_ch_absmax"][i], alpha)
        ln2, (gate, up), _ = smooth_norm_fcs(
            lp["ln2"]["w"], [mlp["gate"]["w"], mlp["up"]["w"]], st["gate_in_ch_absmax"][i],
            alpha)
        layers.append({
            **lp, "ln1": {"w": ln1}, "ln2": {"w": ln2},
            "attn": {**attn, "wpack": {**attn["wpack"], "w": wp}},
            "mlp": {**mlp, "gate": {**mlp["gate"], "w": gate}, "up": {**mlp["up"], "w": up}}})
    return {**params, "layers": layers}


def _sections(w: torch.Tensor):
    """W_pack's float [D, 3D] weight as its q, k and v sections [D, D]."""
    d = w.shape[0]
    return [w[:, i * d:(i + 1) * d] for i in range(3)]


def _pack_wpack_int8(p, input_scale, gran):
    """W_pack as one int8 [3D, D] weight: each section quantized per tensor,
    its scale (times the per-tensor input scale) repeated over its D
    columns of the [3D] dequant vector."""
    qs, ss = zip(*(qmath.quantize_weight_per_tensor_absmax(s) for s in _sections(p["w"])))
    sec = torch.stack([s.reshape(()) for s in ss]).float()
    if gran == PER_TENSOR:
        sec = sec * input_scale
    d = p["w"].shape[0]
    return {"w": torch.cat(qs, dim=1).t().contiguous(),
            "dequant_scale": sec.repeat_interleave(d)}


def _pack_wpack_fp8(p, qcfg: QuantConfig):
    """W_pack in fp8: e5m2 a scale-free cast; e4m3 each section with its own
    scale, a [3D] ``w_scale``."""
    if qcfg.type == "fp8_e5m2":
        return {"w": p["w"].to(qcfg.fp8_dtype).t().contiguous()}
    qs, ss = zip(*(qmath.quantize_fp8_per_tensor(s, qcfg.fp8_dtype) for s in _sections(p["w"])))
    d = p["w"].shape[0]
    return {"w": torch.cat(qs, dim=1).t().contiguous(),
            "w_scale": torch.stack([s.reshape(()) for s in ss]).float().repeat_interleave(d)}


def quantize(params, qcfg: QuantConfig, scales=None, cfg: Optional[BaichuanConfig] = None, *,
             ignore=frozenset(), quantize_output: bool = False, observer_scales=None):
    """The quantized params of float ``params`` (the reference's
    Int8BaichuanForCausalLM.from_float; fp8 and int4 family-wide, as the
    JAX module extends them), in the port's layout on the params' device.
    ``scales``: ``layer_scales`` output (int8; fp8 static without
    ``observer_scales``). int8 folds the per-tensor input scales of W_pack
    and gate|up into ln1 and ln2; int4 packs W_pack as one grouped weight;
    fp8 leaves the projections in ``ignore`` (keys of HF_PROJ_NAMES) float."""
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
        new = []
        for i, lp in enumerate(layers):
            attn_in, out_in = sc["attn_input_scale"][i], sc["out_input_scale"][i]
            gate_in, down_in = sc["gate_input_scale"][i], sc["down_input_scale"][i]
            attn, mlp = lp["attn"], lp["mlp"]
            new.append({
                "ln1": {"w": lp["ln1"]["w"] / attn_in if qcfg.qkv == PER_TENSOR
                        else lp["ln1"]["w"]},
                "attn": {"wpack": _pack_wpack_int8(attn["wpack"], attn_in, qcfg.qkv),
                         "o": pack_int8(attn["o"], out_in, qcfg.out, LinearKind.SCALED)},
                "ln2": {"w": lp["ln2"]["w"] / gate_in if qcfg.fc1 == PER_TENSOR
                        else lp["ln2"]["w"]},
                "mlp": {"gate": pack_int8(mlp["gate"], gate_in, qcfg.fc1, LinearKind.POST_NORM),
                        "up": pack_int8(mlp["up"], gate_in, qcfg.fc1, LinearKind.POST_NORM),
                        "down": pack_int8(mlp["down"], down_in, qcfg.fc2, LinearKind.SCALED)}})
        return {**params, "layers": new}
    return _quantize_fp8(params, qcfg, scales, ignore=ignore, quantize_output=quantize_output,
                         observer_scales=observer_scales)


def _quantize_fp8(params, qcfg: QuantConfig, scales, *, ignore, quantize_output,
                  observer_scales):
    """fp8 packing: W_pack with per-section scales as a [3D] vector, the
    other projections as ``models/llama.py`` packs them; e4m3 static adds
    input (and output) scales from the observer pass, or from the int8
    layer scales without one."""
    def fp8(key, p):
        if key in ignore:
            return dict(p)
        return _pack_wpack_fp8(p, qcfg) if key == "wpack" else pack_fp8(p, qcfg)

    new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
            "attn": {k: fp8(k, v) for k, v in lp["attn"].items()},
            "mlp": {k: fp8(k, v) for k, v in lp["mlp"].items()}} for lp in params["layers"]]
    if qcfg.type == "fp8_e4m3" and qcfg.activation_scheme == "static":
        legacy = {"wpack": "attn_input_scale", "o": "out_input_scale",
                  "gate": "gate_input_scale", "up": "gate_input_scale",
                  "down": "down_input_scale"}
        add_static_fp8_scales(new, qcfg, scales, _GROUPS, legacy, ignore=ignore,
                              quantize_output=quantize_output,
                              observer_scales=observer_scales)
    return {**params, "layers": new}
