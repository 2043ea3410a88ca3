"""Simulated ("fake") quantization, the accuracy-study path (the port of
``autosmoothquant_tpu/quant/fake_quant.py``): weights and activations are
quantized and dequantized in float, so the effect of int8 on a model can be
studied without the int8 execution path. Not wired into the CLIs, as in the
reference."""

from __future__ import annotations

from typing import Any

import torch

from . import math as qmath

WEIGHT_MODES = ("per_channel", "per_tensor")
ACT_MODES = ("per_token", "per_tensor")


def fake_quantize_weight(w: torch.Tensor, mode: str = "per_channel") -> torch.Tensor:
    """[in, out] float weight -> the same weight after an int8 round trip
    (per output channel or per tensor), in w's dtype."""
    if mode == "per_channel":
        q, scales = qmath.quantize_weight_per_channel_absmax(w, axis=0)
    elif mode == "per_tensor":
        q, scales = qmath.quantize_weight_per_tensor_absmax(w)
    else:
        raise ValueError(f"mode {mode!r} not in {WEIGHT_MODES}")
    return (q.float() * scales).to(w.dtype)


def fake_quantize_act(x: torch.Tensor, mode: str = "per_token") -> torch.Tensor:
    if mode == "per_token":
        return qmath.fake_quantize_act_per_token(x)
    if mode == "per_tensor":
        return qmath.fake_quantize_act_per_tensor(x)
    raise ValueError(f"mode {mode!r} not in {ACT_MODES}")


def fake_quantize_params(params: Any, weight_mode: str = "per_channel",
                         skip_keys: tuple = ("embed", "lm_head", "final_norm",
                                             "router")) -> Any:
    """Round-trip every projection weight of a float params tree (a dict key
    "w" holding a 2-D tensor, outside ``skip_keys``) through int8; the model
    then runs its float forward on them. The port's layers are a list of
    per-layer dicts, so each layer's weight is quantized alone, as the JAX
    package quantizes each slice of its stacked [L, in, out] leaves."""

    def walk(node, path=()):
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if (k == "w" and isinstance(v, torch.Tensor) and v.ndim == 2
                    and not any(s in path for s in skip_keys)):
                out[k] = fake_quantize_weight(v, weight_mode)
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(params)
