"""HuggingFace checkpoints -> the port's params (the port of
``autosmoothquant_tpu/convert/hf.py``), with no ``transformers``: tensors
come from the directory's safetensors files (``convert/safetensors_io.py``)
or ``pytorch_model*.bin`` shards (``torch.load``).

Float checkpoints (``load_hf_params``) map to the layout
``convert/from_jax.py:params_from_jax`` gives the JAX package's float params:
a list of per-layer dicts, projection weights [in, out] (HF's [out, in]
transposed) in the requested dtype, norm weights and LayerNorm biases f32, a
projection's bias under "bias". The quantized checkpoints the reference's
``save_pretrained`` writes (``load_reference_quantized``: int8 [out, in]
weights with their ``dequant_scale`` and ``quant_scale`` buffers, norms
already folded) map straight into the port's quantized layout, whose weights
are [out, in] too. Conversions run on the target device: a bf16 checkpoint
is copied there as it is stored and widened there.

Gemma rides the Llama layout after the JAX mapper's folds (norm weights 1 +
w, the embedding times sqrt(hidden), the tied head from the unscaled
embedding); Baichuan keeps its fused W_pack and row-normalizes the NormHead
lm_head; Mixtral stacks each expert projection to a leading [E] (the expert
count read from the checkpoint) beside its float router.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Dict, Optional

import torch

from ..runtime import resolve_device


def hf_config_dict(model_path: str) -> Dict[str, Any]:
    """The checkpoint's config.json."""
    with open(os.path.join(model_path, "config.json"), "r", encoding="utf-8") as f:
        return json.load(f)


class _Reader:
    """Leaves of a state dict, converted on ``device``."""

    def __init__(self, sd, dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, device

    def raw(self, name) -> torch.Tensor:
        return torch.as_tensor(self.sd[name]).to(self.device)

    def weight(self, name) -> torch.Tensor:
        """An HF [out, in] weight as [in, out] in the target dtype."""
        return self.raw(name).to(self.dtype).t().contiguous()

    def leaf(self, name) -> torch.Tensor:
        return self.raw(name).to(self.dtype)

    def norm(self, name) -> torch.Tensor:
        return self.raw(name).float()

    def has(self, name) -> bool:
        return name in self.sd


def _proj(r: _Reader, base: str, bias_key: str = "bias") -> Dict[str, torch.Tensor]:
    p = {"w": r.weight(base + ".weight")}
    if r.has(base + ".bias"):
        p[bias_key] = r.leaf(base + ".bias")
    return p


def llama_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                 dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """HF Llama (and Qwen2, with its q/k/v biases) names -> the port's float
    params. A checkpoint without ``lm_head.weight`` ties it to the
    embedding."""
    r = _Reader(sd, dtype, resolve_device(device))
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {n: _proj(r, f"{b}.self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "mlp": {n: _proj(r, f"{b}.mlp.{n}_proj") for n in ("gate", "up", "down")},
        })
    p = {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
         "final_norm": {"w": r.norm("model.norm.weight")}}
    head = "lm_head.weight" if r.has("lm_head.weight") else "model.embed_tokens.weight"
    p["lm_head"] = {"w": r.weight(head)}
    return p


def opt_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                               dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """HF OPT names -> the port's float params (every projection with its
    bias; project_in / project_out and the final LayerNorm where the
    checkpoint has them)."""
    r = _Reader(sd, dtype, resolve_device(device))

    def ln(name):
        return {"w": r.norm(name + ".weight"), "b": r.norm(name + ".bias")}

    layers = []
    for i in range(num_layers):
        b = f"model.decoder.layers.{i}"
        layers.append({
            "ln1": ln(f"{b}.self_attn_layer_norm"),
            "attn": {"q": _proj(r, f"{b}.self_attn.q_proj"),
                     "k": _proj(r, f"{b}.self_attn.k_proj"),
                     "v": _proj(r, f"{b}.self_attn.v_proj"),
                     "o": _proj(r, f"{b}.self_attn.out_proj")},
            "ln2": ln(f"{b}.final_layer_norm"),
            "mlp": {"fc1": _proj(r, f"{b}.fc1"), "fc2": _proj(r, f"{b}.fc2")},
        })
    p = {"embed": {"w": r.leaf("model.decoder.embed_tokens.weight")},
         "embed_pos": {"w": r.leaf("model.decoder.embed_positions.weight")},
         "layers": layers}
    if r.has("model.decoder.final_layer_norm.weight"):
        p["final_norm"] = ln("model.decoder.final_layer_norm")
    for name in ("project_in", "project_out"):
        if r.has(f"model.decoder.{name}.weight"):
            p[name] = {"w": r.weight(f"model.decoder.{name}.weight")}
    head = "lm_head.weight" if r.has("lm_head.weight") else "model.decoder.embed_tokens.weight"
    p["lm_head"] = {"w": r.weight(head)}
    return p


def gemma_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                 dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """HF Gemma names -> the port's Llama-layout float params, with the JAX
    mapper's folds: norm weights stored as 1 + w (HF computes x * (1 + w)),
    the embedding times sqrt(hidden) (in f32, then the target dtype), and the
    tied lm_head built from the unscaled embedding first."""
    p = llama_params_from_state_dict(sd, num_layers, dtype=dtype, device=device)
    for lp in p["layers"]:
        lp["ln1"]["w"] = lp["ln1"]["w"] + 1.0
        lp["ln2"]["w"] = lp["ln2"]["w"] + 1.0
    p["final_norm"]["w"] = p["final_norm"]["w"] + 1.0
    emb = p["embed"]["w"]
    scale = torch.tensor(math.sqrt(emb.shape[1]), dtype=torch.float32)
    p["embed"]["w"] = (emb.float() * scale.to(emb.device)).to(dtype)
    return p


def _norm_head(r: "_Reader", name: str) -> torch.Tensor:
    """The NormHead lm_head [V, D] with its rows L2-normalized (inference
    mode), in f32, as [D, V] in the target dtype."""
    lm = r.raw(name).float()
    lm = lm / (torch.linalg.vector_norm(lm, dim=1, keepdim=True) + 1e-12)
    return lm.to(r.dtype).t().contiguous()


def baichuan_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                    dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """HF Baichuan names -> the port's float params: W_pack as one [D, 3D]
    projection, the NormHead lm_head row-normalized once."""
    r = _Reader(sd, dtype, resolve_device(device))
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {"wpack": _proj(r, f"{b}.self_attn.W_pack"),
                     "o": _proj(r, f"{b}.self_attn.o_proj")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "mlp": {n: _proj(r, f"{b}.mlp.{n}_proj") for n in ("gate", "up", "down")},
        })
    return {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"w": r.norm("model.norm.weight")},
            "lm_head": {"w": _norm_head(r, "lm_head.weight")}}


def _expert_count(sd) -> int:
    """The experts of a Mixtral state dict: one more than the highest expert
    index of its keys (the JAX mappers infer it the same way)."""
    found = [int(k.split(".experts.")[1].split(".")[0]) for k in sd if ".experts." in k]
    if not found:
        raise ValueError("no expert weights found in the state dict")
    return 1 + max(found)


def mixtral_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                   dtype=torch.float32, device="cuda",
                                   num_experts: Optional[int] = None) -> Dict[str, Any]:
    """HF Mixtral names -> the port's float params: each expert projection
    stacked [E, in, out], the router ([D, E], the HF "gate") float."""
    r = _Reader(sd, dtype, resolve_device(device))
    n_exp = num_experts or _expert_count(sd)
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        moe = f"{b}.block_sparse_moe"
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {n: _proj(r, f"{b}.self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "moe": {"router": {"w": r.weight(f"{moe}.gate.weight")},
                    **{w: {"w": torch.stack([r.weight(f"{moe}.experts.{e}.{w}.weight")
                                             for e in range(n_exp)])}
                       for w in ("w1", "w3", "w2")}},
        })
    return {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"w": r.norm("model.norm.weight")},
            "lm_head": {"w": r.weight("lm_head.weight")}}

_LOADERS: Dict[str, Callable] = {
    "llama": llama_params_from_state_dict,
    "transformers": opt_params_from_state_dict,  # the reference's OPT family tag
    "opt": opt_params_from_state_dict,
    "baichuan": baichuan_params_from_state_dict,
    "mixtral": mixtral_params_from_state_dict,
    "gemma": gemma_params_from_state_dict,
}


def register_loader(family: str, fn: Callable) -> None:
    _LOADERS[family] = fn


def load_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint directory, as CPU tensors: its
    ``*.safetensors`` files, else its ``pytorch_model*.bin`` shards."""
    from .safetensors_io import load_safetensors

    sd: Dict[str, torch.Tensor] = {}
    entries = sorted(os.listdir(model_path))
    st_files = [e for e in entries if e.endswith(".safetensors")]
    bin_files = [e for e in entries if e.endswith(".bin") and "pytorch_model" in e]
    if st_files:
        for fname in st_files:
            sd.update(load_safetensors(os.path.join(model_path, fname)))
    elif bin_files:
        for fname in bin_files:
            sd.update(torch.load(os.path.join(model_path, fname), map_location="cpu",
                                 weights_only=True))
    else:
        raise FileNotFoundError(f"no model weights found under {model_path}")
    return sd


def load_hf_params(model_path_or_sd, family: str, num_layers: int,
                   dtype=torch.float32, *, device="cuda"):
    """The port's float params of a state dict or checkpoint directory, on
    ``device``. ``family``: "llama", "gemma", "baichuan", "mixtral", "opt" (or
    the reference's tag for it, "transformers")."""
    sd = (model_path_or_sd if isinstance(model_path_or_sd, dict)
          else load_state_dict(model_path_or_sd))
    return _LOADERS[family](sd, num_layers, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The reference's quantized checkpoints (its save_pretrained output: int8
# [out, in] weights with f32 dequant_scale, and quant_scale for a
# per-tensor o_proj / down_proj / fc2, buffers per projection; norm weights
# already divided by their consumers' input scales)
# ---------------------------------------------------------------------------


def _qproj(r: _Reader, base: str) -> Dict[str, torch.Tensor]:
    w = r.raw(base + ".weight")
    if w.dtype != torch.int8:
        raise TypeError(f"{base}: expected int8 weights, got {w.dtype}")
    p = {"w": w.contiguous(), "dequant_scale": r.raw(base + ".dequant_scale").float()}
    for key in ("quant_scale", "bias"):
        if r.has(f"{base}.{key}"):
            p[key] = r.raw(f"{base}.{key}").float()
    return p


def quantized_llama_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                           dtype=torch.float32,
                                           device="cuda") -> Dict[str, Any]:
    """A reference int8 Llama checkpoint -> the port's quantized params."""
    r = _Reader(sd, dtype, resolve_device(device))
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {n: _qproj(r, f"{b}.self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "mlp": {n: _qproj(r, f"{b}.mlp.{n}_proj") for n in ("gate", "up", "down")},
        })
    head = "lm_head.weight" if r.has("lm_head.weight") else "model.embed_tokens.weight"
    return {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"w": r.norm("model.norm.weight")},
            "lm_head": {"w": r.weight(head)}}


def quantized_opt_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                         dtype=torch.float32,
                                         device="cuda") -> Dict[str, Any]:
    """A reference int8 OPT checkpoint (LayerNorm weights and biases already
    folded) -> the port's quantized params."""
    r = _Reader(sd, dtype, resolve_device(device))

    def ln(name):
        return {"w": r.norm(name + ".weight"), "b": r.norm(name + ".bias")}

    layers = []
    for i in range(num_layers):
        b = f"model.decoder.layers.{i}"
        layers.append({
            "ln1": ln(f"{b}.self_attn_layer_norm"),
            "attn": {"q": _qproj(r, f"{b}.self_attn.q_proj"),
                     "k": _qproj(r, f"{b}.self_attn.k_proj"),
                     "v": _qproj(r, f"{b}.self_attn.v_proj"),
                     "o": _qproj(r, f"{b}.self_attn.out_proj")},
            "ln2": ln(f"{b}.final_layer_norm"),
            "mlp": {"fc1": _qproj(r, f"{b}.fc1"), "fc2": _qproj(r, f"{b}.fc2")},
        })
    p = {"embed": {"w": r.leaf("model.decoder.embed_tokens.weight")},
         "embed_pos": {"w": r.leaf("model.decoder.embed_positions.weight")},
         "layers": layers,
         "final_norm": ln("model.decoder.final_layer_norm"),
         "lm_head": {"w": r.weight("lm_head.weight")}}
    for name in ("project_in", "project_out"):
        if r.has(f"model.decoder.{name}.weight"):
            p[name] = {"w": r.weight(f"model.decoder.{name}.weight")}
    return p


def quantized_baichuan_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                              dtype=torch.float32,
                                              device="cuda") -> Dict[str, Any]:
    """A reference int8 Baichuan checkpoint -> the port's quantized params.
    Its W_pack is one int8 [3D, D] weight with three per-section scalars
    (q/k/v_dequant_scale), each repeated over its D columns of the [3D]
    dequant vector; the norms arrive folded; the raw NormHead lm_head is
    row-normalized as the float mapper does."""
    r = _Reader(sd, dtype, resolve_device(device))
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        w = r.raw(f"{b}.self_attn.W_pack.weight")
        if w.dtype != torch.int8:
            raise TypeError(f"{b}.self_attn.W_pack: expected int8 weights, got {w.dtype}")
        d = w.shape[1]
        sec = torch.stack([r.raw(f"{b}.self_attn.W_pack.{s}_dequant_scale").float().reshape(())
                           for s in ("q", "k", "v")])
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {"wpack": {"w": w.contiguous(), "dequant_scale": sec.repeat_interleave(d)},
                     "o": _qproj(r, f"{b}.self_attn.o_proj")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "mlp": {n: _qproj(r, f"{b}.mlp.{n}_proj") for n in ("gate", "up", "down")},
        })
    return {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"w": r.norm("model.norm.weight")},
            "lm_head": {"w": _norm_head(r, "lm_head.weight")}}


def quantized_mixtral_params_from_state_dict(sd: Dict[str, Any], num_layers: int,
                                             dtype=torch.float32, device="cuda",
                                             num_experts: Optional[int] = None
                                             ) -> Dict[str, Any]:
    """A reference int8 Mixtral checkpoint -> the port's quantized params:
    each expert's int8 [out, in] weight stacked [E, N, K] with its dequant
    (and, for w2, quant) scalar stacked [E]; the router float (the reference
    does not quantize the gate); the norms arrive folded."""
    r = _Reader(sd, dtype, resolve_device(device))
    n_exp = num_experts or _expert_count(sd)
    layers = []
    for i in range(num_layers):
        b = f"model.layers.{i}"
        moe = f"{b}.block_sparse_moe"
        layers.append({
            "ln1": {"w": r.norm(f"{b}.input_layernorm.weight")},
            "attn": {n: _qproj(r, f"{b}.self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "ln2": {"w": r.norm(f"{b}.post_attention_layernorm.weight")},
            "moe": {"router": {"w": r.weight(f"{moe}.gate.weight")},
                    **{w: _qexperts(r, moe, w, n_exp) for w in ("w1", "w3", "w2")}},
        })
    return {"embed": {"w": r.leaf("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"w": r.norm("model.norm.weight")},
            "lm_head": {"w": r.weight("lm_head.weight")}}


def _qexperts(r: _Reader, moe: str, w: str, n_exp: int) -> Dict[str, torch.Tensor]:
    """One reference int8 expert projection of every expert: its leaves
    stacked to a leading [E] (the per-expert scalars to [E])."""
    ps = [_qproj(r, f"{moe}.experts.{e}.{w}") for e in range(n_exp)]
    return {k: torch.stack([p[k] if k == "w" else p[k].reshape(()) for p in ps])
            for k in ps[0]}


# (the reference writes no quantized Gemma checkpoint; a Gemma artifact is the
# port's own, read by convert/pipeline.py:load_quantized)
_QUANTIZED_LOADERS: Dict[str, Callable] = {
    "llama": quantized_llama_params_from_state_dict,
    "transformers": quantized_opt_params_from_state_dict,
    "opt": quantized_opt_params_from_state_dict,
    "baichuan": quantized_baichuan_params_from_state_dict,
    "mixtral": quantized_mixtral_params_from_state_dict,
}


def load_reference_quantized(model_path: str, family: str, num_layers: int,
                             dtype=torch.float32, *, device="cuda"):
    """A reference-produced quantized checkpoint directory: (params on
    ``device``, QuantConfig of its quant_config.json)."""
    from ..quant.config import parse_quant_config

    params = _QUANTIZED_LOADERS[family](load_state_dict(model_path), num_layers,
                                        dtype=dtype, device=device)
    return params, parse_quant_config(os.path.join(model_path, "quant_config.json"))
