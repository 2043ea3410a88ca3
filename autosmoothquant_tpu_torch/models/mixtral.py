"""Mixtral family (top-2 routed experts, GQA attention, a float router): the
port of ``autosmoothquant_tpu/models/mixtral.py``.

Params (``convert/hf.py:mixtral_params_from_state_dict``,
``convert/from_jax.py``):
    {"embed":      {"w": [V, D]},
     "layers":     [{"ln1": {"w": f32 [D]},
                     "attn": {"q", "k", "v", "o"},
                     "ln2": {"w": f32 [D]},
                     "moe": {"router": {"w": float [D, E]},
                             "w1", "w3", "w2": experts}}, ...],
     "final_norm": {"w": f32 [D]},
     "lm_head":    {"w": [D, V]}}
An attention projection is as in ``models/llama.py``. An expert projection
holds every expert's leaf with a leading [E]: float {"w": [E, in, out]};
int8 {"w": int8 [E, N, K], "dequant_scale": f32 [E], ("quant_scale": [E])};
fp8 {"w": [E, N, K], ("w_scale", "input_scale", "output_scale": [E])}; int4
{"w": uint8 [E, N, K'/2], "w_scales": f32 [E, N, G]}. ``w[e]`` is expert e's
contiguous [N, K] operand: each expert projection is one launch of the
kernel the format takes (K1 int8, K4 fp8, K5 int4), as JAX's per-expert
``linear`` calls run.

What the reference keeps (the JAX module's docstring): the router stays
float in every format; w1 and w3 share one input scale (folded into ln2 for
per-tensor int8), w2 has one a expert; calibration routes every token to
every expert (``CALIBRATION_FORWARD_KWARGS``); routing is a softmax over
the E router logits in f32, the top k, renormalized.

The experts' two routes, JAX's rule (``_moe_block``): T >= 4 E tokens and no
statistics take the sparse route (each expert over its capacity bucket of
``expert_capacity`` rows, gathered through static [E, C] tables; overflow is
dropped, as JAX's ``mode="drop"`` scatter drops it), anything else the dense
route (every expert over all T rows, weight 0 for a token it does not
serve). Both are free of host reads and data-dependent shapes, so a decode
step (dense) and a speculative verify (either) capture as CUDA graphs; a
dropped pair lands in a scratch column of the tables, never past a buffer.
Both combine in f32 in ascending expert order, element by element, so a
token's output is the same bits on either route (unless dropped) and in any
batch. The second norm runs through ``rmsnorm_quant`` unquantized (its f32
output feeds the router, and the experts' int8 input is rounded from it),
the router through the port's own row-alone GEMV (``kernels/moe.py``);
under per-tensor int8 the first norm is the RMSNorm + int8 kernel, as in
``models/baichuan.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.fp8 import fp8_matmul
from ..kernels.fused import rmsnorm_quant
from ..kernels.gemm import int8_matmul
from ..kernels.moe import router_logits
from ..quant import math as qmath
from ..quant.config import PER_TENSOR, PER_TOKEN, QuantConfig
from ..runtime import resolve_device
from ..shard.mesh import axis_of
from .common import (
    LinearKind,
    absmax_ch,
    apply_rope,
    as_tensor,
    cache_mask_and_routing,
    forward_plan,
    is_quantized,
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

FAMILY = "mixtral"

# calibrate() passes these to the float model's statistics pass: every token
# routed to every expert (the reference's top_k = num_experts trick)
CALIBRATION_FORWARD_KWARGS = {"calibrate_all_experts": True}


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    rope_theta: float = 1e6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf) -> "MixtralConfig":
        g = ((lambda k, d=None: hf.get(k, d)) if isinstance(hf, dict)
             else (lambda k, d=None: getattr(hf, k, d)))
        return cls(
            vocab_size=g("vocab_size"),
            hidden_size=g("hidden_size"),
            intermediate_size=g("intermediate_size"),
            num_hidden_layers=g("num_hidden_layers"),
            num_attention_heads=g("num_attention_heads"),
            num_key_value_heads=g("num_key_value_heads"),
            num_local_experts=g("num_local_experts", 8),
            num_experts_per_tok=g("num_experts_per_tok", 2),
            max_position_embeddings=g("max_position_embeddings", 32768),
            rms_norm_eps=g("rms_norm_eps", 1e-5),
            rope_theta=g("rope_theta", 1e6),
        )


config_from_hf = MixtralConfig.from_hf


def init_params(cfg: MixtralConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random float params from a seeded ``torch.Generator`` (JAX
    ``init_params``'s scales: N(0, 1/K) projections and router, N(0, 0.02^2)
    embedding and lm_head, unit norms)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    D, I, V, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_local_experts)
    HD = cfg.num_attention_heads * cfg.head_dim
    KVD = cfg.num_key_value_heads * cfg.head_dim

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    def ones():
        return {"w": torch.ones(D, dtype=torch.float32, device=dev)}

    layers = [{"ln1": ones(),
               "attn": {"q": {"w": w(D, HD)}, "k": {"w": w(D, KVD)}, "v": {"w": w(D, KVD)},
                        "o": {"w": w(HD, D)}},
               "ln2": ones(),
               "moe": {"router": {"w": w(D, E)}, "w1": {"w": w(E, D, I)},
                       "w3": {"w": w(E, D, I)}, "w2": {"w": w(E, I, D)}}}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": {"w": w(V, D, scale=0.02)}, "layers": layers,
            "final_norm": ones(), "lm_head": {"w": w(D, V, scale=0.02)}}


# ---------------------------------------------------------------------------
# routing and dispatch (JAX mixtral.py:244-271, 383-387)
# ---------------------------------------------------------------------------


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def expert_capacity(T: int, E: int, K: int, factor: float = 2.0) -> int:
    """Rows of an expert's bucket: ``factor`` times the balanced load,
    rounded up to 8, never more than T rounded up to 8 (where nothing can
    drop)."""
    c = _round_up(max(8, int(math.ceil(T * K / E * factor))), 8)
    return min(c, _round_up(T, 8))


def route(x2: torch.Tensor, router: torch.Tensor, k: int):
    """(top_w f32 [T, k], top_idx int64 [T, k]) of the norm output x2 [T, D]:
    the router's f32 logits, a softmax over the experts, the top k
    (descending; of equal probabilities the lower expert first, as
    ``lax.top_k`` takes them: a probability that underflows to 0 ties),
    renormalized."""
    probs = torch.softmax(router_logits(x2, router), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_idx


def dispatch_indices(top_idx: torch.Tensor, T: int, E: int, K: int, C: int):
    """The sparse route's tables (JAX ``_dispatch_indices``): gather int64
    [E, C], each slot's token (T for a pad slot), and slot int64 [T, K],
    where each (token, k) pair sits in the flat [E * C] buckets (E * C, one
    past them, for a pair past its expert's capacity; JAX's combine weights
    are top_w at these slots). Pairs fill an expert's slots in token order,
    then k order; a pair past capacity is written to a scratch column C of an
    [E, C + 1] table, which is cut off (JAX drops the write)."""
    dev = top_idx.device
    flat_e = top_idx.reshape(-1).long()
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    onehot = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int32)
    flat_pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0].long()
    gather = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    gather.index_put_((flat_e, torch.clamp(flat_pos, max=C)), flat_t)
    slot = torch.where(flat_pos < C, flat_e * C + flat_pos, torch.full_like(flat_pos, E * C))
    return gather[:, :C], slot.reshape(T, K)


# ---------------------------------------------------------------------------
# expert projections
# ---------------------------------------------------------------------------


def _expert(p: dict, e: int) -> dict:
    """Expert e's projection: each leaf's [e] view."""
    return {k: v[e] for k, v in p.items()}


def _fp8_static(qcfg: QuantConfig, p: dict) -> bool:
    return qcfg.activation_scheme == "static" and "input_scale" in p


def _shared_input(x2: torch.Tensor, p: dict, qcfg: Optional[QuantConfig], gran: str,
                  sparse: bool):
    """w1's and w3's quantized input, the same for every expert: (operand,
    row scale or None) of the norm output x2, or None where each expert's
    projection quantizes its own (float or int4 weights, static fp8 with a
    scale a expert). int8 per-tensor rounds the prescaled x2, per-token
    takes its row scales; fp8 e4m3 dynamic scales per tensor on the dense
    route (JAX's ``linear`` at the configured granularity) and per row on
    the sparse one (JAX's ``_batched_expert_linear``)."""
    if qcfg is None or not is_quantized(p) or qcfg.is_int4:
        return None
    if qcfg.type == "int8":
        if gran == PER_TOKEN:
            return qmath.quantize_act_per_token(x2)
        return qmath.quantize_act_prescaled(x2), None
    if qcfg.type == "fp8_e5m2":
        return x2.to(torch.float8_e5m2), None
    if _fp8_static(qcfg, p):
        return None
    if sparse or gran == PER_TOKEN:
        return qmath.quantize_fp8_per_token(x2)
    return qmath.quantize_fp8_per_tensor(x2)


def _prequant_matmul(q: torch.Tensor, rs, pe: dict, qcfg: QuantConfig, out_dtype):
    """One expert's product of a shared quantized input (:func:`_shared_input`)."""
    rs = 1.0 if rs is None else rs
    if qcfg.type == "int8":
        return int8_matmul(q, pe["w"], row_scale=rs, col_scale=pe["dequant_scale"],
                           out_dtype=out_dtype)
    return fp8_matmul(q, pe["w"], row_scale=rs, col_scale=pe.get("w_scale", 1.0),
                      out_dtype=out_dtype)


def _proj(x, shared, p, e, qcfg, gran, kind, out_dtype, sparse, row_mesh=None):
    """Expert e's projection of x [R, in] (its rows: all T, or its bucket),
    from the shared quantized input where there is one; ``row_mesh`` (w2
    with the experts' inner dimensions split) sums it over "model"."""
    pe = _expert(p, e)
    if shared is not None:
        return _prequant_matmul(shared[0], shared[1], pe, qcfg, out_dtype)
    if (sparse and qcfg is not None and qcfg.type == "fp8_e4m3" and is_quantized(pe)
            and not _fp8_static(qcfg, pe)):
        gran = PER_TOKEN  # JAX's bucketed fp8 scales each row
    return row_linear(x, pe, qcfg, gran, kind, out_dtype, row_mesh)


def _expert_mlp(x, shared, mp, e, qcfg, compute_dtype, sparse, row_mesh=None):
    """(w1 out, w3 out, silu(w1) * w3, w2 out) of the e-th expert this rank
    holds over rows x."""
    gran1 = qcfg.fc1 if qcfg else PER_TENSOR
    gran2 = qcfg.fc2 if qcfg else PER_TENSOR
    g = _proj(x, shared, mp["w1"], e, qcfg, gran1, LinearKind.POST_NORM, compute_dtype, sparse)
    u = _proj(x, shared, mp["w3"], e, qcfg, gran1, LinearKind.POST_NORM, compute_dtype, sparse)
    act = (F.silu(g.float()) * u.float()).to(compute_dtype)
    down = _proj(act, None, mp["w2"], e, qcfg, gran2, LinearKind.SCALED, compute_dtype, sparse,
                 row_mesh)
    return g, u, act, down


def _local_experts(plan, E: int):
    """(first expert, count) this rank holds: all E, or its share of the
    expert axis."""
    if plan is None or plan.experts == 1:
        return 0, E
    n = E // plan.experts
    return plan.expert_index * n, n


def moe_dense(x2, mp, cfg: MixtralConfig, qcfg, compute_dtype, top_w, top_idx, stats=None,
              plan=None, row_mesh=None, keep_f32=False):
    """Every expert over all T rows (JAX ``_moe_block``'s dense route): a
    token's output is the f32 sum, in ascending expert order, of weight x
    expert output (weight 0 where the token is not routed). ``stats`` (a
    dict) receives the routed-masked per-expert statistics. With ``plan``'s
    experts split, the sum covers this rank's experts (:func:`moe_block`
    adds the ranks' sums; ``keep_f32`` returns the f32 sum)."""
    T = x2.shape[0]
    E = cfg.num_local_experts
    e0, n_local = _local_experts(plan, E)
    weights = torch.zeros((T, E), dtype=torch.float32, device=x2.device)
    weights.scatter_(1, top_idx, top_w.float())
    shared = _shared_input(x2, mp["w1"], qcfg, qcfg.fc1 if qcfg else PER_TENSOR, False)
    acc = None
    per_expert = []
    for j in range(n_local):
        e = e0 + j
        g, u, act, down = _expert_mlp(x2, shared, mp, j, qcfg, compute_dtype, False, row_mesh)
        term = down.float() * weights[:, e:e + 1]
        acc = term if acc is None else acc + term
        if stats is not None:
            routed = (weights[:, e] > 0)[:, None]
            per_expert.append(((act.float().abs() * routed).amax(dim=0),
                               (g.float().abs() * routed).amax(),
                               (u.float().abs() * routed).amax(),
                               (down.float().abs() * routed).amax()))
    if stats is not None:
        stats["moe_in_ch_absmax"] = absmax_ch(x2)
        for i, key in enumerate(("down_in_ch_absmax_per_expert", "w1_out_absmax_per_expert",
                                 "w3_out_absmax_per_expert", "w2_out_absmax_per_expert")):
            stats[key] = torch.stack([s[i] for s in per_expert])
    return acc if keep_f32 else acc.to(compute_dtype)


def _pad_row(t: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """t [T, ...] with one more row of ``fill`` (the pad slots' source)."""
    row = t.new_zeros((1, *t.shape[1:]))
    return torch.cat([t, row if fill == 0.0 else row.fill_(fill)])


def moe_sparse(x2, mp, cfg: MixtralConfig, qcfg, compute_dtype, top_w, top_idx,
               capacity_factor: float = 2.0, plan=None, row_mesh=None, keep_f32=False):
    """Each expert over its capacity bucket (JAX ``_moe_block_sparse``): one
    projection launch a expert over its C rows, gathered from x2 (or from
    its shared quantization) with pad slots reading a zero row; a token's
    output gathers its K experts' rows in ascending expert order (a dropped
    pair reads a zero row) and sums weight x output in f32 in that order.
    With ``plan``'s experts split, other ranks' experts' rows read zeros and
    :func:`moe_block` adds the ranks' sums; ``keep_f32`` returns the f32
    sum."""
    T, D = x2.shape
    E, K = cfg.num_local_experts, top_idx.shape[1]
    e0, n_local = _local_experts(plan, E)
    C = expert_capacity(T, E, K, capacity_factor)
    gather, slot = dispatch_indices(top_idx, T, E, K, C)
    shared = _shared_input(x2, mp["w1"], qcfg, qcfg.fc1 if qcfg else PER_TENSOR, True)
    if shared is not None:
        q = _pad_row(shared[0])
        rs = None if shared[1] is None else _pad_row(shared[1], 1.0)
    x_pad = _pad_row(x2)
    outs = []
    for j in range(n_local):
        rows = gather[e0 + j]
        sh = None if shared is None else (q[rows], None if rs is None else rs[rows])
        outs.append(_expert_mlp(x_pad[rows], sh, mp, j, qcfg, compute_dtype, True, row_mesh)[3])
    local = torch.cat(outs)
    if n_local < E:
        down = local.new_zeros((E * C + 1, local.shape[1]))
        down[e0 * C:(e0 + n_local) * C] = local
    else:
        down = _pad_row(local)                                # [E * C + 1, D]
    order = torch.argsort(top_idx, dim=-1)
    slot, w = slot.gather(1, order), top_w.float().gather(1, order)
    acc = down[slot[:, 0]].float() * w[:, :1]
    for k in range(1, K):
        acc = acc + down[slot[:, k]].float() * w[:, k:k + 1]
    return acc if keep_f32 else acc.to(compute_dtype)


def use_sparse(T: int, E: int, capture: bool, all_experts: bool) -> bool:
    """JAX's route rule without its ASQ_MOE override: the sparse route at
    T >= 4 E tokens, never under statistics capture or all-experts
    calibration."""
    return not capture and not all_experts and T >= 4 * E


def moe_block(x2, mp, cfg: MixtralConfig, qcfg, compute_dtype, *, all_experts=False,
              stats=None, plan=None, mesh=None):
    """The MoE block of the norm output x2 (f32 [T, D]): route, then the
    route :func:`use_sparse` picks. Returns [T, D] in compute_dtype.

    Under a mesh (``plan``): the router is whole on every rank, so every
    rank routes every token alike; a rank runs the experts it holds (its
    share of the "expert" axis) and, where their inner dimensions split over
    "model", sums w2 over it (K1's int32 partials for int8: exact); the
    ranks of the expert axis then add their f32 sums. A token has two
    routed experts, so that sum is the one-card a + b, bit for bit; int4
    experts run whole on each rank (JAX ``_moe_int4_sharded``)."""
    E = cfg.num_local_experts
    top_w, top_idx = route(x2, mp["router"]["w"], E if all_experts else cfg.num_experts_per_tok)
    row_mesh = mesh if plan is not None and plan.expert_mlp else None
    if use_sparse(x2.shape[0], E, stats is not None, all_experts):
        out = moe_sparse(x2, mp, cfg, qcfg, compute_dtype, top_w, top_idx, plan=plan,
                         row_mesh=row_mesh, keep_f32=True)
    else:
        out = moe_dense(x2, mp, cfg, qcfg, compute_dtype, top_w, top_idx, stats, plan=plan,
                        row_mesh=row_mesh, keep_f32=True)
    if plan is not None and plan.experts > 1:
        axis_of(mesh, "expert").all_reduce(out)
    return out.to(compute_dtype)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def _qkv_prescaled(qcfg: Optional[QuantConfig], attn) -> bool:
    """Per-tensor int8 q|k|v with the input scale folded into ln1: the first
    norm then runs as the RMSNorm + int8 kernel."""
    return (qcfg is not None and qcfg.is_int8 and qcfg.qkv == PER_TENSOR
            and attn["q"]["w"].dtype == torch.int8)


def _layer_forward(h, lp, cfg: MixtralConfig, qcfg: Optional[QuantConfig], cos, sin,
                   mask, cache, cache_index, compute_dtype, *, plain_causal=False,
                   chunk0=False, banded=False, banded_starts=None, kv_window=None,
                   all_experts=False, stats=None, plan=None, mesh=None):
    """One decoder layer; h: [B, T, D] in compute_dtype. The cache (if any)
    is written in place; ``stats``, a dict, receives the layer's calibration
    statistics (JAX ``_layer_forward``'s and ``_moe_block``'s)."""
    b, t, d = h.shape
    hd = cfg.head_dim
    n_q, n_kv = plan.q_heads, plan.kv_heads
    capture = stats is not None
    attn = lp["attn"]
    if not capture and _qkv_prescaled(qcfg, attn):
        x_q = rmsnorm_quant(h.reshape(b * t, d), lp["ln1"]["w"], eps=cfg.rms_norm_eps)
        q, k, v = (linear_prequant(x_q, attn[n], compute_dtype).reshape(b, t, -1)
                   for n in ("q", "k", "v"))
    else:
        x = rms_norm(h, lp["ln1"]["w"], cfg.rms_norm_eps)
        if capture:
            stats["qkv_in_ch_absmax"] = absmax_ch(x)
        gran = qcfg.qkv if qcfg else PER_TENSOR
        q, k, v = (linear(x, attn[n], qcfg, gran, LinearKind.POST_NORM, out_dtype=compute_dtype)
                   for n in ("q", "k", "v"))
    if capture:
        for name, y in (("q", q), ("k", k), ("v", v)):
            stats[f"{name}_out_absmax"] = y.abs().amax()
    q = apply_rope(q.reshape(b, t, n_q, hd), cos, sin)
    k = plan.local_kv(apply_rope(k.reshape(b, t, n_kv, hd), cos, sin))
    v = plan.local_kv(v.reshape(b, t, n_kv, hd))
    ctx = update_and_attend(q, k, v, cache, cache_index, mask, 1.0 / math.sqrt(hd),
                            compute_dtype, plain_causal=plain_causal, chunk0_causal=chunk0,
                            banded=banded, banded_starts=banded_starts, kv_window=kv_window)
    ctx = ctx.reshape(b, t, n_q * hd)
    attn_out = row_linear(ctx, attn["o"], qcfg, qcfg.out if qcfg else PER_TENSOR,
                          LinearKind.SCALED, compute_dtype, mesh if plan.attn else None)
    if capture:
        stats["o_in_ch_absmax"] = absmax_ch(ctx)
        stats["o_out_absmax"] = attn_out.abs().amax()
    h = h + attn_out
    # the second norm in f32 (JAX's rms_norm output), read by the router and
    # rounded to the experts' int8 input
    x2 = rmsnorm_quant(h.reshape(b * t, d).float(), lp["ln2"]["w"], eps=cfg.rms_norm_eps,
                       quantize=False)
    moe = moe_block(x2, lp["moe"], cfg, qcfg, compute_dtype, all_experts=all_experts,
                    stats=stats, plan=plan, mesh=mesh)
    return h + moe.reshape(b, t, d)


def forward(params, input_ids: torch.Tensor, cfg: MixtralConfig,
            quant_config: Optional[QuantConfig] = None, *,
            kv_cache=None, cache_index=None,
            kv_valid: Optional[torch.Tensor] = None,
            pad_starts: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            kv_window: Optional[int] = None,
            capture_stats: bool = False,
            calibrate_all_experts: bool = False,
            compute_dtype=torch.float32, mesh=None):
    """Run the decoder stack: the arguments and results of
    ``models/llama.py:forward`` (contiguous, paged or a verify's rows; with
    ``capture_stats`` the statistics under ``STAT_KEYS`` too), and
    ``calibrate_all_experts``: every token routed to every expert. ``mesh``:
    a rank's params, cache and rows (attention as ``models/llama.py``'s,
    the experts by :func:`moe_block`)."""
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
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    per_layer = []
    for i, lp in enumerate(params["layers"]):
        stats = {} if capture_stats else None
        h = _layer_forward(
            h, lp, cfg, quant_config, cos, sin, mask,
            kv_cache[i] if kv_cache is not None else None, cache_index, compute_dtype,
            plain_causal=plain_causal, chunk0=chunk0, banded=chunkN, banded_starts=pad_starts,
            kv_window=kv_window, all_experts=calibrate_all_experts, stats=stats, plan=plan,
            mesh=mesh)
        per_layer.append(stats)
    h = stage_output(h, lambda x: head(params, x, cfg, compute_dtype), mesh)
    if capture_stats:
        return h, kv_cache, {k: torch.stack([st[k] for st in per_layer]) for k in STAT_KEYS}
    return h, kv_cache


def logits(params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """lm_head (float): f32 [B, T, V] (a rank's vocab slice gathered over
    ``mesh``)."""
    return lm_logits(params, hidden, mesh)


def init_kv_cache(cfg: MixtralConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """dtype torch.int8 selects the int8 cache (values + per-token-per-head
    scales)."""
    return make_kv_cache(cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
                         cfg.head_dim, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# calibration statistics, smoothing and quantization (JAX mixtral.py:628-912)
# ---------------------------------------------------------------------------

STAT_KEYS = (
    "qkv_in_ch_absmax", "q_out_absmax", "k_out_absmax", "v_out_absmax",
    "o_in_ch_absmax", "o_out_absmax", "moe_in_ch_absmax",
    "down_in_ch_absmax_per_expert", "w1_out_absmax_per_expert",
    "w3_out_absmax_per_expert", "w2_out_absmax_per_expert",
)

# HF module-name suffix per projection key (fp8 ignore patterns); an expert
# projection is named by expert 0's and is ignored for every expert or none
HF_PROJ_NAMES = {
    "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
    "o": "self_attn.o_proj", "w1": "block_sparse_moe.experts.0.w1",
    "w3": "block_sparse_moe.experts.0.w3",
    "w2": "block_sparse_moe.experts.0.w2",
}
_ATTN = ("q", "k", "v", "o")
_EXPERTS = ("w1", "w3", "w2")


def act_scales_dict(stats) -> Dict[str, torch.Tensor]:
    """Stacked statistics -> the reference's act_scales dict (HF module
    names): q, k, v and o's per-channel input absmax, the router's (the MoE
    input) and each expert's w2's."""
    stats = {k: as_tensor(v) for k, v in stats.items()}
    out = {}
    for i in range(stats["qkv_in_ch_absmax"].shape[0]):
        base = f"model.layers.{i}"
        for n in ("q", "k", "v"):
            out[f"{base}.self_attn.{n}_proj"] = stats["qkv_in_ch_absmax"][i]
        out[f"{base}.self_attn.o_proj"] = stats["o_in_ch_absmax"][i]
        out[f"{base}.block_sparse_moe.gate"] = stats["moe_in_ch_absmax"][i]
        for e in range(stats["down_in_ch_absmax_per_expert"].shape[1]):
            out[f"{base}.block_sparse_moe.experts.{e}.w2"] = \
                stats["down_in_ch_absmax_per_expert"][i, e]
    return out


def _ch_div(stats, key, by):
    return qmath.true_div(as_tensor(stats[key]).amax(dim=-1), by)


def layer_scales(stats) -> Dict[str, torch.Tensor]:
    """int8 scales (absmax / 127): [L] for attention and the shared MoE input,
    [L, E] ``down_input_scales`` (the reference's
    collect_mixtral_layer_scales)."""
    def div(x):
        return qmath.true_div(as_tensor(x), qmath.INT8_MAX)

    return {
        "attn_input_scale": _ch_div(stats, "qkv_in_ch_absmax", qmath.INT8_MAX),
        "q_output_scale": div(stats["q_out_absmax"]),
        "k_output_scale": div(stats["k_out_absmax"]),
        "v_output_scale": div(stats["v_out_absmax"]),
        "out_input_scale": _ch_div(stats, "o_in_ch_absmax", qmath.INT8_MAX),
        "moe_input_scale": _ch_div(stats, "moe_in_ch_absmax", qmath.INT8_MAX),
        "down_input_scales": _ch_div(stats, "down_in_ch_absmax_per_expert", qmath.INT8_MAX),
    }


def fp8_observer_scales(stats) -> Dict[str, torch.Tensor]:
    """fp8 input and output scales (absmax / 448): [L] for attention, [L, E]
    for the experts (w1 and w3 share the MoE input's, broadcast over E)."""
    m = qmath.FP8_E4M3_MAX
    E = as_tensor(stats["down_in_ch_absmax_per_expert"]).shape[1]
    moe_in = _ch_div(stats, "moe_in_ch_absmax", m)
    shared = moe_in[:, None].expand(moe_in.shape[0], E).contiguous()

    def div(key):
        return qmath.true_div(as_tensor(stats[key]), m)

    return {
        "q_input_scale": _ch_div(stats, "qkv_in_ch_absmax", m),
        "k_input_scale": _ch_div(stats, "qkv_in_ch_absmax", m),
        "v_input_scale": _ch_div(stats, "qkv_in_ch_absmax", m),
        "o_input_scale": _ch_div(stats, "o_in_ch_absmax", m),
        "q_output_scale": div("q_out_absmax"),
        "k_output_scale": div("k_out_absmax"),
        "v_output_scale": div("v_out_absmax"),
        "o_output_scale": div("o_out_absmax"),
        "w1_input_scale": shared,
        "w3_input_scale": shared.clone(),
        "w2_input_scale": _ch_div(stats, "down_in_ch_absmax_per_expert", m),
        "w1_output_scale": div("w1_out_absmax_per_expert"),
        "w3_output_scale": div("w3_out_absmax_per_expert"),
        "w2_output_scale": div("w2_out_absmax_per_expert"),
    }


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def smooth(params, stats, alpha: float = 0.5, cfg: Optional[MixtralConfig] = None):
    """The reference's smooth_lm Mixtral branch: ln1 -> q, k, v by the qkv
    input statistics; ln2 -> the router and every expert's w1 and w3 by the
    MoE input statistics."""
    from ..quant.smooth import smooth_norm_fcs

    st = scales_on({k: stats[k] for k in ("qkv_in_ch_absmax", "moe_in_ch_absmax")},
                   _device(params))
    layers = []
    for i, lp in enumerate(params["layers"]):
        attn, mp = lp["attn"], lp["moe"]
        ln1, (q, k, v), _ = smooth_norm_fcs(lp["ln1"]["w"], [attn[n]["w"] for n in "qkv"],
                                            st["qkv_in_ch_absmax"][i], alpha)
        E = mp["w1"]["w"].shape[0]
        fcs = ([mp["router"]["w"]] + [mp["w1"]["w"][e] for e in range(E)]
               + [mp["w3"]["w"][e] for e in range(E)])
        ln2, new, _ = smooth_norm_fcs(lp["ln2"]["w"], fcs, st["moe_in_ch_absmax"][i], alpha)
        layers.append({
            **lp, "ln1": {"w": ln1}, "ln2": {"w": ln2},
            "attn": {**attn, **{n: {**attn[n], "w": w} for n, w in zip("qkv", (q, k, v))}},
            "moe": {**mp, "router": {**mp["router"], "w": new[0]},
                    "w1": {**mp["w1"], "w": torch.stack(new[1:1 + E])},
                    "w3": {**mp["w3"], "w": torch.stack(new[1 + E:])}}})
    return {**params, "layers": layers}


def _experts(fn, p) -> Dict[str, torch.Tensor]:
    """Apply a per-projection pack ``fn`` to every expert of ``p`` (float
    [E, in, out]) and stack each leaf to [E, ...]."""
    packed = [fn({"w": p["w"][e]}, e) for e in range(p["w"].shape[0])]
    return {k: torch.stack([pe[k] for pe in packed]) for k in packed[0]}


def quantize(params, qcfg: QuantConfig, scales=None, cfg: Optional[MixtralConfig] = None, *,
             ignore=frozenset(), quantize_output: bool = False, observer_scales=None):
    """The quantized params of float ``params`` (the reference's
    Int8MixtralForCausalLM.from_float; fp8 and int4 as the JAX module
    extends them), in the port's layout on the params' device; the router
    stays float in every format. int8: attention as Llama's, the experts with
    per-expert weight scales, w1 and w3 sharing ``moe_input_scale`` (folded
    into ln2 for per-tensor fc1), w2 with ``down_input_scales`` [L, E]. fp8:
    per-expert weight scales; e4m3 static adds input (and output) scales
    [E] from the observer pass, or from the int8 scales without one; the
    projections in ``ignore`` stay float. int4: grouped weights."""
    layers = params["layers"]
    if qcfg.is_int4:
        def int4(p):
            return _experts(lambda pe, e: pack_int4(pe, qcfg.group_size), p)

        new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
                "attn": {k: pack_int4(v, qcfg.group_size) for k, v in lp["attn"].items()},
                "moe": {"router": dict(lp["moe"]["router"]),
                        **{k: int4(lp["moe"][k]) for k in _EXPERTS}}}
               for lp in layers]
        return {**params, "layers": new}
    if not qcfg.is_int8:
        return _quantize_fp8(params, qcfg, scales, ignore=ignore,
                             quantize_output=quantize_output, observer_scales=observer_scales)
    if scales is None:
        raise ValueError("int8 quantization needs layer_scales")
    sc = scales_on(scales, _device(params))
    new = []
    for i, lp in enumerate(layers):
        attn_in, out_in = sc["attn_input_scale"][i], sc["out_input_scale"][i]
        moe_in, down_in = sc["moe_input_scale"][i], sc["down_input_scales"][i]
        attn, mp = lp["attn"], lp["moe"]

        def experts(p, input_scale, gran, kind):
            return _experts(lambda pe, e: pack_int8(
                pe, input_scale if input_scale.ndim == 0 else input_scale[e], gran, kind), p)

        new.append({
            "ln1": {"w": lp["ln1"]["w"] / attn_in if qcfg.qkv == PER_TENSOR
                    else lp["ln1"]["w"]},
            "attn": {**{n: pack_int8(attn[n], attn_in, qcfg.qkv, LinearKind.POST_NORM)
                        for n in "qkv"},
                     "o": pack_int8(attn["o"], out_in, qcfg.out, LinearKind.SCALED)},
            "ln2": {"w": lp["ln2"]["w"] / moe_in if qcfg.fc1 == PER_TENSOR
                    else lp["ln2"]["w"]},
            "moe": {"router": dict(mp["router"]),
                    "w1": experts(mp["w1"], moe_in, qcfg.fc1, LinearKind.POST_NORM),
                    "w3": experts(mp["w3"], moe_in, qcfg.fc1, LinearKind.POST_NORM),
                    "w2": experts(mp["w2"], down_in, qcfg.fc2, LinearKind.SCALED)}})
    return {**params, "layers": new}


def _quantize_fp8(params, qcfg: QuantConfig, scales, *, ignore, quantize_output,
                  observer_scales):
    """fp8 packing: attention as Llama's, each expert with its own weight
    scale; e4m3 static adds input (and output) scales: [L] leaves for
    attention, [E] a layer for the experts."""
    def fp8(key, p, experts):
        if key in ignore:
            return dict(p)
        return _experts(lambda pe, e: pack_fp8(pe, qcfg), p) if experts else pack_fp8(p, qcfg)

    new = [{"ln1": dict(lp["ln1"]), "ln2": dict(lp["ln2"]),
            "attn": {k: fp8(k, v, False) for k, v in lp["attn"].items()},
            "moe": {"router": dict(lp["moe"]["router"]),
                    **{k: fp8(k, lp["moe"][k], True) for k in _EXPERTS}}}
           for lp in params["layers"]]
    if qcfg.type == "fp8_e4m3" and qcfg.activation_scheme == "static":
        keys = [(n, "attn") for n in _ATTN] + [(n, "moe") for n in _EXPERTS]
        if observer_scales is not None:
            obs = scales_on(observer_scales, _device(params))
            for i, lp in enumerate(new):
                for name, grp in keys:
                    if name in ignore:
                        continue
                    lp[grp][name]["input_scale"] = obs[f"{name}_input_scale"][i]
                    if quantize_output:
                        lp[grp][name]["output_scale"] = obs[f"{name}_output_scale"][i]
        else:
            if scales is None:
                raise ValueError("fp8 static needs observer scales")
            if quantize_output:
                raise ValueError("quantize_output needs observer_scales")
            sc = scales_on(scales, _device(params))
            f = 127.0 / qmath.FP8_E4M3_MAX
            legacy = {"q": "attn_input_scale", "k": "attn_input_scale",
                      "v": "attn_input_scale", "o": "out_input_scale"}
            for i, lp in enumerate(new):
                E = lp["moe"]["w1"]["w"].shape[0]
                for name, key in legacy.items():
                    if name not in ignore:
                        lp["attn"][name]["input_scale"] = sc[key][i] * f
                shared = (sc["moe_input_scale"][i] * f).expand(E).contiguous()
                for name in ("w1", "w3"):
                    if name not in ignore:
                        lp["moe"][name]["input_scale"] = shared.clone()
                if "w2" not in ignore:
                    lp["moe"]["w2"]["input_scale"] = sc["down_input_scales"][i] * f
    return {**params, "layers": new}
