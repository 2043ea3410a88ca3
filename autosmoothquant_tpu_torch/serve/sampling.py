"""Token sampling: greedy / temperature / top-k / top-p (the port of
``autosmoothquant_tpu/serve/sampling.py``).

Randomness comes from an explicit ``torch.Generator`` on the logits' device
(Gumbel-max over the filtered logits, the same construction as
``jax.random.categorical``; the two generators give different bits, so
sampled paths are compared by distribution). Nothing here reads a value back
to the host.
"""

from __future__ import annotations

import torch

from ..quant import math as qmath


def _thresholds_per_row(scaled: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Smallest kept logit per row under top-k AND top-p, via one sort.

    scaled: [B, V] f32 (temperature applied), top_k: [B] int (0 = off),
    top_p: [B] f32 (>= 1 = off). Returns [B, 1]; logits strictly below it
    are masked."""
    v = scaled.shape[-1]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    k = torch.clamp(k, 1, v).long()
    kth = torch.gather(desc, -1, (k - 1)[:, None])
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose exclusive prefix mass is < p: the first is always
    # kept, and the token that crosses p is included (HF semantics)
    nkeep = torch.clamp_min(((cum - probs) < top_p[:, None]).sum(-1), 1)
    pth = torch.gather(desc, -1, (nkeep - 1)[:, None])
    return torch.maximum(kth, pth)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """HF convention: seen tokens' positive logits divide by the penalty,
    negative ones multiply. logits [B, V]; seen bool [B, V]; penalty [B]."""
    logits = logits.float()
    p = penalty[:, None]
    pen = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen & (p != 1.0), pen, logits)


def _gumbel_argmax(scaled: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def sample_per_row(logits: torch.Tensor, generator: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """[B, V] logits -> [B] int64 tokens under per-row parameters ([B]
    tensors on the logits' device: f32 temperature, int top_k, f32 top_p),
    so one step serves a batch that mixes greedy and sampled rows. A row with
    temperature 0 takes the argmax; one draw from ``generator`` serves the
    whole batch."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    use = temperature > 0.0
    scaled = logits / torch.where(use, temperature, 1.0)[:, None]
    thresh = _thresholds_per_row(scaled, top_k, top_p)
    drawn = _gumbel_argmax(scaled.masked_fill(scaled < thresh, float("-inf")),
                           generator)
    return torch.where(use, drawn, greedy)


def sample(logits: torch.Tensor, generator: torch.Generator = None,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """[B, V] logits -> [B] int64 tokens; temperature 0 is argmax."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = qmath.true_div(logits, temperature)
    if top_k > 0 or top_p < 1.0:
        b = scaled.shape[0]
        thresh = _thresholds_per_row(
            scaled, torch.full((b,), top_k, dtype=torch.int64, device=scaled.device),
            torch.full((b,), top_p, dtype=torch.float32, device=scaled.device))
        scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    return _gumbel_argmax(scaled, generator)
