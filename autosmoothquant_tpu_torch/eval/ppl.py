"""Perplexity of a token stream, the reference's procedure
(``examples/eval_model.py:56-105``; the port of
``autosmoothquant_tpu/eval/ppl.py``):

  - the stream splits into consecutive non-overlapping windows of
    ``max_length`` (nsamples = total // max_length; the remainder dropped);
  - a window's nll is its mean cross entropy over the T - 1 shifted
    positions times ``max_length`` (the reference's quirk, kept so the
    numbers compare);
  - ppl = exp(sum(nll) / (nsamples * max_length)).

``batch_windows`` windows run in one forward; a batch past the stream's end
is filled with copies of the last window, whose results are dropped. Each
window's f32 mean cross entropy stays on the device until the pass ends,
then comes to the host in one copy and is summed as Python floats in the
JAX package's order.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..quant.config import QuantConfig
from ..runtime import resolve_device


def token_logprobs(model_mod, params, hidden: torch.Tensor, ids: torch.Tensor):
    """(f32 log-probability of ids[:, t + 1] at position t [B, T - 1], whether
    it is the argmax [B, T - 1]) from the last hidden states [B, T, D]. The
    lm_head and its log-softmax run a row at a time, so the f32 logits and
    their log-softmax [T, V] exist for one row only (not [B, T, V] twice)."""
    lps, greedy = [], []
    for b in range(hidden.shape[0]):
        logp = torch.log_softmax(model_mod.logits(params, hidden[b:b + 1, :-1])[0], dim=-1)
        target = ids[b, 1:].long()
        lps.append(logp.gather(-1, target[:, None])[:, 0])
        greedy.append(logp.argmax(-1) == target)
        del logp
    return torch.stack(lps), torch.stack(greedy)


def window_mean_ce(model_mod, params, cfg, windows: torch.Tensor, qcfg, compute_dtype):
    """f32 [B]: each window's mean cross entropy over its T - 1 positions."""
    h, _ = model_mod.forward(params, windows, cfg, qcfg, compute_dtype=compute_dtype)
    lps, _ = token_logprobs(model_mod, params, h, windows)
    return -lps.mean(dim=-1)


def perplexity_from_tokens(model_mod, params, cfg, tokens: np.ndarray,
                           max_length: int = 2048,
                           qcfg: Optional[QuantConfig] = None,
                           compute_dtype=torch.float32,
                           progress: bool = False,
                           batch_windows: int = 1,
                           mesh=None, microbatches: int = 4,
                           device="cuda") -> float:
    """Perplexity of the 1-D token stream ``tokens`` (the reference's
    testenc) under the port's model on ``device`` (``params`` live there).
    ``progress`` prints a line a batch to stderr. A stage ``mesh``
    (pipeline-parallel windows, the JAX package's ``shard/pipeline.py``)
    raises NotImplementedError: the port runs on one card (ROADMAP Queue 1,
    item 17b)."""
    if mesh is not None:
        raise NotImplementedError(
            "perplexity over a stage mesh (pipeline parallelism) is not ported yet "
            "(ROADMAP Queue 1, item 17b); the port runs on one card")
    dev = resolve_device(device)
    tokens = np.asarray(tokens).reshape(-1)
    nsamples = tokens.size // max_length
    if nsamples == 0:
        raise ValueError(f"token stream ({tokens.size}) shorter than window "
                         f"({max_length})")
    bw = max(batch_windows, 1)
    windows = torch.from_numpy(
        tokens[:nsamples * max_length].astype(np.int64).reshape(nsamples, max_length))
    ces = []
    with torch.inference_mode():
        for i in range(0, nsamples, bw):
            idx = [min(j, nsamples - 1) for j in range(i, i + bw)]
            batch = windows[idx].to(dev)
            keep = min(bw, nsamples - i)   # the tail's clamped copies are dropped
            ces.append(window_mean_ce(model_mod, params, cfg, batch, qcfg, compute_dtype)[:keep])
            if progress:
                print(f"ppl: {i + keep}/{nsamples} windows", file=sys.stderr, flush=True)
        mean_ce = torch.cat(ces).cpu().numpy()
    # the reference's quirk: each window's mean CE times max_length
    nlls = [float(c) * max_length for c in mean_ce]
    return float(np.exp(np.sum(nlls) / (nsamples * max_length)))


def perplexity(model_mod, params, cfg, text_tokens, **kw) -> float:
    return perplexity_from_tokens(model_mod, params, cfg, text_tokens, **kw)
