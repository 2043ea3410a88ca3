"""Tensor- and expert-parallel sharding rules of the model zoo: the port of
``autosmoothquant_tpu/shard/sharding.py``.

The specs are JAX's, leaf for leaf (a spec is a tuple of axis names or None
a dimension, JAX's ``PartitionSpec`` as a tuple, over JAX's stacked [L, ...]
leaves): q/k/v/gate/up/fc1/W_pack column-parallel, o/down/fc2 row-parallel,
the lm_head column-parallel over the vocab, norms, embeddings and scalar
scales replicated, Mixtral's experts over "expert" (or, with no expert axis,
their inner dimensions over "model"), a dimension that does not divide
replicated (:func:`_maybe`).

What :func:`shard_params` gives a rank differs from JAX's device shards in
the port's layout and in three rules, all stated by :func:`tp_plan`:
  - quantized weights are [N, K] (``convert/from_jax.py``): JAX's "in" is
    the port's last dimension, its "out" the one before; int4 group scales
    [N, G] likewise;
  - JAX's partitioner reshards whatever a device lacks; here each rank
    computes on what it holds, so a block splits over "model" only where
    whole heads (attention) or whole int4 groups of both nibble planes
    (row-parallel int4) fall to each rank, and is otherwise kept whole on
    every rank. k/v replicate where the kv heads do not split whole
    (few-KV GQA on a wide model axis): each rank then reads the kv heads its
    query heads map to (``TPPlan.kv_index``);
  - Baichuan's fused ``W_pack`` splits section by section (rank i holds
    q_i | k_i | v_i, whole heads), where JAX splits the fused dimension
    contiguously; Mixtral's per-expert scale vectors [E] all follow their
    experts.
The stage axis (``with_stage_axis``) waits for ROADMAP Queue 1, item 17b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..quant import math as qmath
from .mesh import STAGE_ITEM, Mesh, axis_of

# weight dtypes of quantized projections ([N, K] in the port; uint8: int4)
_QUANT = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2, torch.uint8)


def P(*dims) -> Tuple:
    """A spec: one entry a dimension, an axis name or None."""
    return tuple(dims)


def _maybe(axis_size: int, dim_size: int, axis_name: str):
    """Shard only when divisible (JAX ``_maybe``)."""
    return axis_name if dim_size % axis_size == 0 and axis_size > 1 else None


def _m(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def llama_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    m = _m(mesh)

    def proj(spec_in, spec_out):
        return {"w": P(None, spec_in, spec_out), "dequant_scale": P(None),
                "quant_scale": P(None), "w_scale": P(None), "input_scale": P(None),
                "w_scales": P(None, None, spec_out), "bias": P(None, spec_out)}

    col = _maybe(m, cfg.num_attention_heads * cfg.head_dim, "model")
    kv_col = _maybe(m, cfg.num_key_value_heads * cfg.head_dim, "model")
    ffn_col = _maybe(m, cfg.intermediate_size, "model")
    vocab_col = _maybe(m, cfg.vocab_size, "model")
    return {
        "embed": {"w": P(None, None)},
        "layers": {
            "ln1": {"w": P(None, None)},
            "attn": {"q": proj(None, col), "k": proj(None, kv_col),
                     "v": proj(None, kv_col), "o": proj(col, None)},
            "ln2": {"w": P(None, None)},
            "mlp": {"gate": proj(None, ffn_col), "up": proj(None, ffn_col),
                    "down": proj(ffn_col, None)},
        },
        "final_norm": {"w": P(None)},
        "lm_head": {"w": P(None, vocab_col)},
    }


def opt_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    m = _m(mesh)

    def proj(spec_in, spec_out):
        return {"w": P(None, spec_in, spec_out), "b": P(None, spec_out),
                "bias": P(None, spec_out), "dequant_scale": P(None),
                "quant_scale": P(None), "w_scales": P(None, None, spec_out)}

    col = _maybe(m, cfg.hidden_size, "model")
    ffn_col = _maybe(m, cfg.ffn_dim, "model")
    vocab_col = _maybe(m, cfg.vocab_size, "model")
    norm = {"w": P(None, None), "b": P(None, None)}
    return {
        "embed": {"w": P(None, None)},
        "embed_pos": {"w": P(None, None)},
        "project_in": {"w": P(None, None)},
        "project_out": {"w": P(None, None)},
        "layers": {
            "ln1": norm,
            "attn": {"q": proj(None, col), "k": proj(None, col),
                     "v": proj(None, col), "o": proj(col, None)},
            "ln2": norm,
            "mlp": {"fc1": proj(None, ffn_col), "fc2": proj(ffn_col, None)},
        },
        "final_norm": {"w": P(None), "b": P(None)},
        "lm_head": {"w": P(None, vocab_col)},
    }


def baichuan_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    m = _m(mesh)
    col3 = _maybe(m, cfg.hidden_size, "model")
    col = _maybe(m, cfg.hidden_size, "model")
    ffn_col = _maybe(m, cfg.intermediate_size, "model")
    vocab_col = _maybe(m, cfg.vocab_size, "model")

    def proj(spec_in, spec_out):
        return {"w": P(None, spec_in, spec_out), "dequant_scale": P(None),
                "quant_scale": P(None), "w_scales": P(None, None, spec_out)}

    return {
        "embed": {"w": P(None, None)},
        "layers": {
            "ln1": {"w": P(None, None)},
            "attn": {
                "wpack": {"w": P(None, None, col3), "dequant_scale": P(None, col3),
                          "quant_scale": P(None), "w_scales": P(None, None, col3)},
                "o": {"w": P(None, col, None), "dequant_scale": P(None),
                      "quant_scale": P(None), "w_scales": P(None, None, None)},
            },
            "ln2": {"w": P(None, None)},
            "mlp": {"gate": proj(None, ffn_col), "up": proj(None, ffn_col),
                    "down": {"w": P(None, ffn_col, None), "dequant_scale": P(None),
                             "quant_scale": P(None), "w_scales": P(None, None, None)}},
        },
        "final_norm": {"w": P(None)},
        "lm_head": {"w": P(None, vocab_col)},
    }


def mixtral_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    m = _m(mesh)
    e_ax = "expert" if mesh.shape.get("expert", 1) > 1 else None
    exp = _maybe(mesh.shape.get("expert", 1), cfg.num_local_experts, "expert") if e_ax else None

    def proj(spec_in, spec_out):
        return {"w": P(None, spec_in, spec_out), "dequant_scale": P(None),
                "quant_scale": P(None), "bias": P(None, spec_out),
                "w_scales": P(None, None, spec_out)}

    def expert_proj(spec_in, spec_out):
        return {"w": P(None, exp, spec_in, spec_out), "dequant_scale": P(None, exp),
                "quant_scale": P(None, exp), "w_scales": P(None, exp, None, None)}

    col = _maybe(m, cfg.num_attention_heads * cfg.head_dim, "model")
    kv_col = _maybe(m, cfg.num_key_value_heads * cfg.head_dim, "model")
    ffn_col = _maybe(m, cfg.intermediate_size, "model")
    vocab_col = _maybe(m, cfg.vocab_size, "model")
    return {
        "embed": {"w": P(None, None)},
        "layers": {
            "ln1": {"w": P(None, None)},
            "attn": {"q": proj(None, col), "k": proj(None, kv_col),
                     "v": proj(None, kv_col), "o": proj(col, None)},
            "ln2": {"w": P(None, None)},
            "moe": {"router": {"w": P(None, None, None)},
                    "w1": expert_proj(None, ffn_col), "w3": expert_proj(None, ffn_col),
                    "w2": expert_proj(ffn_col, None)},
        },
        "final_norm": {"w": P(None)},
        "lm_head": {"w": P(None, vocab_col)},
    }


PARAM_SPEC_FNS = {
    "llama": llama_param_specs,
    "gemma": llama_param_specs,
    "transformers": opt_param_specs,
    "opt": opt_param_specs,
    "baichuan": baichuan_param_specs,
    "mixtral": mixtral_param_specs,
}


def param_specs(family: str, cfg, mesh: Mesh):
    return PARAM_SPEC_FNS[family](cfg, mesh)


def kv_heads_of(cfg) -> int:
    return getattr(cfg, "num_key_value_heads", None) or cfg.num_attention_heads


def kv_cache_specs(cfg, mesh: Mesh, shard_batch: bool = True):
    """JAX's specs of the [L, B, S, H_kv, Dh] cache leaves and their
    [L, B, S, H_kv] scales. ``shard_batch=False`` keeps the rows whole (the
    continuous pools)."""
    d = mesh.shape.get("data", 1)
    head = _maybe(_m(mesh), kv_heads_of(cfg), "model")
    batch = "data" if d > 1 and shard_batch else None
    return {"kv": P(None, batch, None, head, None), "kv_scale": P(None, batch, None, head)}


# ---------------------------------------------------------------------------
# what a rank computes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How one rank runs a family's blocks under a mesh (:func:`tp_plan`).

    model, index: the model axis's size and this rank's coordinate on it.
    attn: query heads split over "model" (q column-, o row-parallel); then
    ``q_heads`` from ``q_offset`` are this rank's, its k/v projections give
    ``kv_heads`` heads (all of them where kv replicates) and ``kv_index``
    (None: all of those) picks the ones its attention reads.
    mlp: the MLP's inner dimension split (gate/up/fc1 column-, down/fc2
    row-parallel). vocab: the lm_head split over the vocab (logits
    gathered). experts, expert_index: the expert axis (Mixtral): this rank
    holds experts [expert_index * E / experts, ...). expert_mlp: the
    experts' inner dimensions split over "model"."""

    model: int = 1
    index: int = 0
    attn: bool = False
    q_heads: int = 0
    q_offset: int = 0
    kv_heads: int = 0
    kv_index: Optional[Tuple[int, ...]] = None
    mlp: bool = False
    vocab: bool = False
    experts: int = 1
    expert_index: int = 0
    expert_mlp: bool = False

    def local_kv(self, t: torch.Tensor) -> torch.Tensor:
        """k or v [B, T, kv_heads, D] -> the heads this rank's attention reads."""
        if self.kv_index is None:
            return t
        idx = torch.tensor(self.kv_index, device=t.device)
        return t.index_select(2, idx)

    @property
    def cache_heads(self) -> int:
        return self.kv_heads if self.kv_index is None else len(self.kv_index)

    def slopes(self, slopes: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's query heads' ALiBi slopes."""
        if slopes is None or not self.attn:
            return slopes
        return slopes[self.q_offset:self.q_offset + self.q_heads]


def _int4_row_splits(k: int, group: int, m: int) -> bool:
    """Whether an int4 [N, K'/2] weight's two nibble planes split over m
    ranks in whole groups (JAX ``int4_matmul_tp``'s row condition)."""
    kp = qmath.int4_padded_k(k, group)
    return (kp // (2 * group)) % m == 0


def _kv_index(n_q: int, n_kv: int, m: int, i: int) -> Tuple[int, ...]:
    """The kv heads rank i's query heads [i * n_q / m, ...) read, each once
    where its query heads form equal consecutive groups, else one a query
    head."""
    ql = n_q // m
    g = n_q // n_kv
    idx = [h // g for h in range(i * ql, (i + 1) * ql)]
    uniq = sorted(set(idx))
    c = ql // len(uniq)
    if ql % len(uniq) == 0 and idx == [u for u in uniq for _ in range(c)]:
        return tuple(uniq)
    return tuple(idx)


def tp_plan(family: str, cfg, mesh: Optional[Mesh], qcfg=None) -> TPPlan:
    """The rank's :class:`TPPlan`: a pure function of the config, the mesh's
    sizes and coordinates and the quantization (int4 splits rows in whole
    groups only), so :func:`shard_params` and every forward agree."""
    if axis_of(mesh, "stage").size > 1:
        raise NotImplementedError(f"a stage axis (pipeline parallelism) is not ported yet "
                                  f"({STAGE_ITEM})")
    ax = axis_of(mesh, "model")
    ex = axis_of(mesh, "expert")
    m, i = ax.size, ax.index
    n_q = cfg.num_attention_heads
    n_kv = kv_heads_of(cfg)
    hd = cfg.head_dim
    int4 = qcfg is not None and qcfg.is_int4
    group = getattr(qcfg, "group_size", 128)
    if m == 1:
        return TPPlan(q_heads=n_q, kv_heads=n_kv, experts=ex.size, expert_index=ex.index)
    attn = n_q % m == 0 and not (int4 and not _int4_row_splits(n_q * hd, group, m))
    ffn = cfg.ffn_dim if family in ("opt", "transformers") else cfg.intermediate_size
    mlp = ffn % m == 0 and not (int4 and not _int4_row_splits(ffn, group, m))
    vocab = cfg.vocab_size % m == 0
    experts = ex.size if family == "mixtral" and cfg.num_local_experts % ex.size == 0 else 1
    expert_mlp = family == "mixtral" and mlp and not (int4 and experts > 1)
    if not attn:
        return TPPlan(m, i, False, n_q, 0, n_kv, None, mlp, vocab, experts,
                      ex.index if experts > 1 else 0, expert_mlp)
    kv_split = n_kv % m == 0
    return TPPlan(m, i, True, n_q // m, i * (n_q // m),
                  n_kv // m if kv_split else n_kv,
                  None if kv_split else _kv_index(n_q, n_kv, m, i),
                  mlp, vocab, experts, ex.index if experts > 1 else 0, expert_mlp)


# ---------------------------------------------------------------------------
# a rank's shard of the params
# ---------------------------------------------------------------------------


def _slice(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    w = t.shape[dim] // parts
    return t.narrow(dim, index * w, w).contiguous()


def _sections(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """W_pack's q | k | v along ``dim``, each section's slice ``index``."""
    return torch.cat([_slice(s, dim, parts, index) for s in t.chunk(3, dim=dim)], dim=dim)


def _port_spec(spec: Tuple, key: str, leaf: torch.Tensor) -> Tuple:
    """A per-layer leaf's spec in the port's layout: the stacked [L] dim
    dropped by the caller; quantized [.., N, K] weights and int4 scales
    [.., N, G] take JAX's last two entries swapped."""
    if len(spec) != leaf.ndim:
        return (None,) * leaf.ndim
    if (key == "w" and leaf.dtype in _QUANT) or key == "w_scales":
        return spec[:-2] + (spec[-1], spec[-2])
    return spec


def _shard_leaf(t: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    for dim, name in enumerate(spec):
        if name is not None:
            ax = mesh.axis(name)
            if ax.size > 1:
                t = _slice(t, dim, ax.size, ax.index)
    return t


def _block_proj(p: dict, specs: dict, mesh: Mesh, keep: bool) -> dict:
    """One projection's leaves: ``keep`` whole (the plan keeps its block on
    every rank), else each leaf by its spec."""
    out = {}
    for k, v in p.items():
        if keep or not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        spec = specs.get(k)
        out[k] = _shard_leaf(v, _port_spec(spec[1:], k, v), mesh) if spec else v
    return out


def _wpack(p: dict, plan: TPPlan) -> dict:
    """Baichuan's W_pack section by section: q_i | k_i | v_i."""
    if not plan.attn:
        return p
    out = {}
    for k, v in p.items():
        if not isinstance(v, torch.Tensor) or v.ndim == 0:
            out[k] = v
        elif k == "w" and v.dtype not in _QUANT:
            out[k] = _sections(v, 1, plan.model, plan.index)   # float [D, 3D]
        else:
            out[k] = _sections(v, 0, plan.model, plan.index)   # [3D, ...] or [3D]
    return out


def _experts(p: dict, specs: dict, mesh: Mesh, plan: TPPlan) -> dict:
    """An expert projection: every [E, ...] leaf's local experts, and with
    ``plan.expert_mlp`` the inner dimensions by their spec's model entry."""
    out = {}
    for k, v in p.items():
        if not isinstance(v, torch.Tensor) or v.ndim == 0:
            out[k] = v
            continue
        if plan.experts > 1:
            v = _slice(v, 0, plan.experts, plan.expert_index)
        spec = specs.get(k)
        if plan.expert_mlp and spec:
            dims = _port_spec(spec[1:], k, v)
            v = _shard_leaf(v, tuple(d if d == "model" else None for d in dims), mesh)
        out[k] = v
    return out


_ATTN_ROW = ("o",)
_MLP_COL = ("gate", "up", "fc1")
_MLP_ROW = ("down", "fc2")


def shard_params(params, mesh: Mesh, specs, plan: TPPlan):
    """This rank's shard of the port's params (unfused, every leaf on its
    device already): each leaf by its spec (JAX's, in the port's layout),
    under the plan's rules (module docstring). Leaves without a spec
    replicate."""
    def top(name, block):
        spec = specs.get(name, {})
        if name == "lm_head" and not plan.vocab:
            return block
        return {k: (_shard_leaf(v, _port_spec(spec[k], k, v), mesh)
                    if isinstance(v, torch.Tensor) and k in spec else v)
                for k, v in block.items()}

    lspec = specs["layers"]
    layers = []
    for lp in params["layers"]:
        new = {}
        for group, block in lp.items():
            gspec = lspec.get(group, {})
            if group in ("attn", "mlp"):
                sub = {}
                for name, p in block.items():
                    if name == "wpack":
                        sub[name] = _wpack(p, plan)
                        continue
                    if name in ("qkv", "gateup"):
                        raise ValueError("shard unfused params; a rank fuses its own "
                                         "sections after (serve/engine.py)")
                    keep = not (plan.attn if group == "attn" else plan.mlp)
                    if name in ("k", "v") and plan.kv_index is not None:
                        keep = True  # kv heads that do not split whole replicate
                    sub[name] = _block_proj(p, gspec.get(name, {}), mesh, keep)
                new[group] = sub
            elif group == "moe":
                new[group] = {name: (p if name == "router"
                                     else _experts(p, gspec.get(name, {}), mesh, plan))
                              for name, p in block.items()}
            else:
                new[group] = block
        layers.append(new)
    out = {k: (top(k, v) if isinstance(v, dict) else v) for k, v in params.items()
           if k != "layers"}
    out["layers"] = layers
    return out


def shard_kv_cache(cache, mesh: Mesh, cfg, shard_batch: bool = True,
                   plan: Optional[TPPlan] = None):
    """A rank's slice of a whole cache (a list of per-layer cache objects
    [B, S, H_kv, Dh], scales [B, S, H_kv]): its rows where the batch splits
    over "data" (``shard_batch``), and with ``plan`` the kv heads its
    attention reads (the engines allocate their caches at that size
    instead: ``MeshModel.init_kv_cache``)."""
    d = axis_of(mesh, "data")
    out = []
    for layer in cache:
        fields = {}
        for f in dataclasses.fields(layer):
            t = getattr(layer, f.name)
            if shard_batch and d.size > 1:
                t = _slice(t, 0, d.size, d.index)
            if plan is not None and plan.attn:
                if plan.kv_index is not None:
                    t = t.index_select(2, torch.tensor(plan.kv_index, device=t.device))
                elif plan.kv_heads != t.shape[2]:
                    t = _slice(t, 2, plan.model, plan.index)
            fields[f.name] = t.contiguous()
        out.append(type(layer)(**fields))
    return out


class MeshModel:
    """A family module bound to a mesh: ``forward`` and ``logits`` run as the
    rank's part (the mesh passed to the family's own functions),
    ``init_kv_cache`` allocates the heads the rank's attention reads, and
    every other attribute is the module's. The engines hold one instead of
    the module, so their code is the same on one card and on a mesh."""

    def __init__(self, module, mesh: Mesh, plan: TPPlan):
        self.module, self.mesh, self.plan = module, mesh, plan

    def __getattr__(self, name):
        return getattr(self.module, name)

    def forward(self, *args, **kw):
        return self.module.forward(*args, mesh=self.mesh, **kw)

    def logits(self, params, hidden):
        return self.module.logits(params, hidden, mesh=self.mesh)

    def init_kv_cache(self, cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda"):
        from ..models.common import make_kv_cache

        return make_kv_cache(cfg.num_hidden_layers, batch, max_len, self.plan.cache_heads,
                             cfg.head_dim, dtype, torch.device(device))


def cache_heads(model, cfg) -> int:
    """The kv heads a (possibly mesh-bound) model's cache holds."""
    return model.plan.cache_heads if isinstance(model, MeshModel) else kv_heads_of(cfg)
