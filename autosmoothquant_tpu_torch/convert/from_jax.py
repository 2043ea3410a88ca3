"""Carry the JAX package's params over into the port's layout.

The JAX params are a nested dict whose decoder-layer leaves are stacked
``[L, ...]`` and whose weights are ``[in, out]``. The port keeps a list of
per-layer dicts and stores quantized weights ``[out, in]`` (``nn.Linear``'s
layout), each transposed here, once:
  - int8 and fp8 weights become ``[N, K]``, K-contiguous: the int8 and fp8
    GEMMs stream one output column's bytes contiguously.
  - int4 packed weights ``[K'/2, N]`` become ``[N, K'/2]`` and their group
    scales ``[G, N]`` become ``[N, G]``, for the same reason: a warp of the
    W4A8 kernel reads column n's packed bytes and its G scales as contiguous
    runs. Split-K packing survives the transpose: byte r of column n still
    holds rows r and r + K'/2.
Mixtral's expert projections keep their leading [E] (a per-layer leaf is
``[E, K, N]``, ``[E, K'/2, N]`` or ``[E, G, N]``): the last two dims swap, so
expert e's weight is a contiguous ``[N, K]`` operand, and per-expert scales
``[L, E]`` become ``[E]`` a layer.
Scalar leaves (``dequant_scale``, ``quant_scale``, ``w_scale``,
``input_scale``, ``output_scale``) and biases are carried as they are.
Float weights keep ``[in, out]``; a float projection's bias, which the JAX
float params name ``"b"`` (OPT), becomes ``"bias"``, the name every linear
reads (the quantized formats already use it). Norm weights and LayerNorm
biases (``"w"``, ``"b"``) become f32, the type the fused norm kernels take
(the norms compute in f32 anyway).

Leaves may be numpy arrays (ml_dtypes bf16 and fp8 are recognized by their
dtype names and read through an integer view, with no import) or torch
tensors.

``params_to_jax`` is the inverse, for the artifact writer
(``convert/pipeline.py:save_quantized``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.common import QUANT_DTYPES

_NORMS = ("ln1", "ln2", "final_norm")
# ml_dtypes names -> (integer view of the same width, torch dtype)
_ML_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def to_torch(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bf16 and fp8 included) or tensor as a CPU
    tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name in _ML_DTYPES:
        view, dtype = _ML_DTYPES[a.dtype.name]
        return torch.from_numpy(
            np.ascontiguousarray(a).view(view).copy()).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _proj(p: Dict[str, Any], layer: Optional[int]) -> Dict[str, torch.Tensor]:
    out = {}
    quant = p["w"].dtype in QUANT_DTYPES
    for key, t in p.items():
        if layer is not None:
            t = t[layer]
        if quant and key in ("w", "w_scales"):
            t = t.transpose(-2, -1)
        out["bias" if key == "b" else key] = t.contiguous()
    return out


def _block(tree: Dict[str, Any], layer: Optional[int]):
    out = {}
    for key, sub in tree.items():
        if key in _NORMS:
            out[key] = {k: (t[layer] if layer is not None else t).float().contiguous()
                        for k, t in sub.items()}
        elif isinstance(sub, dict) and "w" in sub:
            out[key] = _proj(sub, layer)
        elif isinstance(sub, dict):
            out[key] = _block(sub, layer)
        else:
            raise ValueError(f"unexpected params leaf {key!r}")
    return out


def params_from_jax(tree: Dict[str, Any], cfg=None, *,
                    device="cuda") -> Dict[str, Any]:
    """JAX params (Llama, Gemma, Baichuan, Mixtral or OPT family; float, int8,
    fp8 or int4; fused q|k|v, gate|up or Baichuan's W_pack, or not) -> the port's
    params on ``device``. ``cfg`` (a
    family's config), when given, is checked against the layer count and
    supplies a tied lm_head where it has ``tie_word_embeddings``."""
    from ..runtime import resolve_device

    dev = resolve_device(device)
    tree = _map(to_torch, tree)
    stacked = tree["layers"]
    n_layers = stacked["ln1"]["w"].shape[0]
    if cfg is not None and n_layers != cfg.num_hidden_layers:
        raise ValueError(f"params hold {n_layers} layers, config says "
                         f"{cfg.num_hidden_layers}")
    top = _block({k: v for k, v in tree.items() if k != "layers"}, None)
    if ("lm_head" not in top and cfg is not None
            and getattr(cfg, "tie_word_embeddings", False)):
        top["lm_head"] = {"w": top["embed"]["w"].t().contiguous()}
    params = {**top, "layers": [_block(stacked, i) for i in range(n_layers)]}
    return _map(lambda t: t.to(dev), params)


def params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params (unfused, as ``params_from_jax`` gives them) in the
    layout ``params_from_jax`` reads, as CPU tensors: decoder-layer leaves
    stacked ``[L, ...]``, quantized weights back to ``[K, N]`` (int4 packed
    ``[K'/2, N]``, group scales ``[G, N]``; Mixtral's experts ``[E, K, N]``). A float projection's bias keeps
    the name ``"bias"``, the one every linear of both packages reads, so the
    round trip through ``params_from_jax`` is exact."""
    host = _map(lambda t: t.detach().cpu(), params)
    top = {k: _untranspose(v) for k, v in host.items() if k != "layers"}
    return {**top, "layers": _stack([_untranspose(lp) for lp in host["layers"]])}


def _untranspose(node):
    if isinstance(node, dict) and "w" in node and node["w"].dtype in QUANT_DTYPES:
        return {k: t.transpose(-2, -1).contiguous() if k in ("w", "w_scales") else t
                for k, t in node.items()}
    if isinstance(node, dict):
        return {k: _untranspose(v) for k, v in node.items()}
    return node


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v) for v in node]
    return fn(node)
