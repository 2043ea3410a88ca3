"""SmoothQuant scale migration over torch tensors (the port of
``autosmoothquant_tpu/quant/smooth.py``), bit-exact against it on equal
inputs at alpha 0.5.

The numeric convention (the reference's smooth.py):
    weight_scales = clamp(max over the fc group of per-in-channel absmax, 1e-5)
    s             = clamp(act_scales^alpha / weight_scales^(1-alpha), 1e-5)
    norm.weight  /= s    (and norm.bias /= s for a LayerNorm)
    fc.weight    *= s    (broadcast over the input-channel dim)

Float weights are stored [in, out] in the port as in the JAX package, so the
per-in-channel absmax reduces over dim 1 and ``s`` broadcasts as a column.

Rounding: at alpha 0.5 both powers are correctly rounded square roots
(``quant/math.py:sqrt_rn``: taken in f64 and rounded once, the same bits on
the CPU and the card; torch's own f32 ``sqrt`` on the CPU is an ulp off in
about one value in six on an AVX-512 host), which is what XLA makes of
``x ** 0.5`` under ``jax.jit``. Outside a jit (the JAX pipeline smooths
eagerly) XLA calls libm's ``powf``, which differs from the square root by an
ulp in about one channel in 2,000; torch's CPU ``pow`` differs in about one
in 150. At other alphas every ``pow`` is its device's own, and ``s`` may
differ by an ulp or two between them. Everything else is exactly rounded
(true division by a tensor on the same device, products, maxima), and every
op stays on the weights' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .math import sqrt_rn


def compute_smooth_scale(act_scales: torch.Tensor, fc_weights: Sequence[torch.Tensor],
                         alpha: float = 0.5) -> torch.Tensor:
    """f32 [in] migration scales of one norm -> fc group."""
    weight_scales = torch.stack([w.abs().amax(dim=1) for w in fc_weights]).amax(dim=0)
    weight_scales = torch.clamp_min(weight_scales.float(), 1e-5)
    act = act_scales.float()
    if alpha == 0.5:
        ratio = sqrt_rn(act) / sqrt_rn(weight_scales)
    else:
        ratio = act.pow(alpha) / weight_scales.pow(1.0 - alpha)
    return torch.clamp_min(ratio, 1e-5)


def smooth_norm_fcs(norm_weight: torch.Tensor, fc_weights: Sequence[torch.Tensor],
                    act_scales: torch.Tensor, alpha: float = 0.5,
                    norm_bias: Optional[torch.Tensor] = None):
    """Smooth one norm -> fc group boundary. Returns (norm_weight',
    [fc_weight', ...], norm_bias' or None), each in its input's dtype."""
    for w in fc_weights:
        if not w.shape[0] == norm_weight.numel() == act_scales.numel():
            raise ValueError(f"in_features mismatch: {w.shape[0]} vs "
                             f"{norm_weight.numel()} vs {act_scales.numel()}")
    s = compute_smooth_scale(act_scales, fc_weights, alpha)
    new_norm = (norm_weight.float() / s).to(norm_weight.dtype)
    new_bias = None
    if norm_bias is not None:
        new_bias = (norm_bias.float() / s).to(norm_bias.dtype)
    new_fcs = [(w.float() * s[:, None]).to(fc_weights[0].dtype) for w in fc_weights]
    return new_norm, new_fcs, new_bias


@dataclasses.dataclass(frozen=True)
class SmoothGroup:
    """One norm -> fcs boundary inside a params tree. Paths are tuples of
    dict keys and list indices (the port's layers are a list), e.g.
    ``("layers", 0, "ln1", "w")``; fc paths point at [in, out] weights;
    ``scale_key`` keys the act_scales dict (the reference keys a boundary by
    its first consumer's HF module name); ``norm_bias_path`` is set for a
    LayerNorm, whose bias is divided too."""

    norm_path: Tuple
    fc_paths: Tuple[Tuple, ...]
    scale_key: str
    norm_bias_path: Optional[Tuple] = None


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    """A copy of ``tree`` with the leaf at ``path`` replaced; only the nodes
    along the path are copied."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    new = list(tree) if isinstance(tree, list) else dict(tree)
    new[head] = _set(tree[head], rest, value)
    return new


def smooth_params(params: Any, act_scales: dict, groups: Sequence[SmoothGroup],
                  alpha: float = 0.5):
    """SmoothQuant migration of every declared group; the input tree is left
    as it is. ``act_scales`` values may be tensors or numpy arrays."""
    for g in groups:
        norm_w = _get(params, g.norm_path)
        fcs = [_get(params, p) for p in g.fc_paths]
        bias = _get(params, g.norm_bias_path) if g.norm_bias_path else None
        scales = act_scales[g.scale_key]
        if not isinstance(scales, torch.Tensor):
            scales = torch.from_numpy(np.array(scales))
        scales = scales.to(norm_w.device)
        new_norm, new_fcs, new_bias = smooth_norm_fcs(norm_w, fcs, scales, alpha, bias)
        params = _set(params, g.norm_path, new_norm)
        for path, w in zip(g.fc_paths, new_fcs):
            params = _set(params, path, w)
        if g.norm_bias_path is not None:
            params = _set(params, g.norm_bias_path, new_bias)
    return params
