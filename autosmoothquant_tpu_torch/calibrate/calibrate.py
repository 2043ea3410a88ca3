"""Activation-statistics calibration (the port of
``autosmoothquant_tpu/calibrate/calibrate.py``).

The model's ``forward(..., capture_stats=True)`` returns each batch's
statistics as device tensors stacked [L, ...]; batches aggregate with an
elementwise ``torch.maximum`` on the device, and the result comes back to
the host in one copy at the end: no value is read back per layer, projection
or batch. One pass gives both the per-channel input absmaxes (for smoothing)
and the scalar absmaxes (for static scales), since a scalar is the max over
its channels; the pipeline calibrates twice, on the float model and on the
smoothed one, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch


def stats_to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device statistics as CPU tensors, through one device-to-host copy per
    dtype (one in all at f32 compute): the leaves are flattened into one
    buffer on the device, copied, then split on the host."""
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(v.dtype for v in stats.values()):
        keys = [k for k, v in stats.items() if v.dtype == dtype]
        flat = torch.cat([stats[k].reshape(-1) for k in keys]).cpu()
        for k, part in zip(keys, flat.split([stats[k].numel() for k in keys])):
            out[k] = part.reshape(stats[k].shape)
    return {k: out[k] for k in stats}


def calibrate(model_mod, params, cfg, batches: Iterable, compute_dtype=torch.float32,
              extra_forward_kwargs: Optional[dict] = None,
              qcfg=None) -> Dict[str, torch.Tensor]:
    """Run the model over calibration batches and return its statistics:
    {STAT_KEYS: CPU tensor [L, ...]}, the elementwise max over the batches.

    model_mod: a family module (``models/llama.py``, ``models/gemma.py``,
    ``models/baichuan.py``, ``models/mixtral.py``, ``models/opt.py``);
    ``extra_forward_kwargs`` its ``CALIBRATION_FORWARD_KWARGS`` where it has
    them (Mixtral: every token to every expert).
    batches: int token id arrays or tensors [B, T]. qcfg: None for the float
    model; a QuantConfig with matching quantized params observes the scales
    through the quantized forward (the fp8 observer pass). The forward runs
    on the params' device; on the card with f32 compute its float products
    run in f32 (TF32 off, as the port leaves it)."""
    kwargs = dict(extra_forward_kwargs or {})
    device = params["embed"]["w"].device
    agg = None
    with torch.inference_mode():
        for ids in batches:
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.long).to(device)
            _, _, stats = model_mod.forward(params, ids, cfg, qcfg, capture_stats=True,
                                            compute_dtype=compute_dtype, **kwargs)
            agg = stats if agg is None else {k: torch.maximum(agg[k], v)
                                             for k, v in stats.items()}
    if agg is None:
        raise ValueError("calibration got zero batches")
    return stats_to_host(agg)


def calibration_batches(token_stream: np.ndarray, num_samples: int = 512,
                        seq_len: int = 512, seed: int = 42,
                        batch_size: int = 8) -> Iterable[np.ndarray]:
    """Batches of int32 windows [batch_size, seq_len] at
    ``np.random.default_rng(seed)`` starts of a 1-D token stream;
    ``num_samples`` is rounded down to whole batches (at least one)."""
    rng = np.random.default_rng(seed)
    n = token_stream.shape[0]
    if n <= seq_len:
        raise ValueError("token stream shorter than seq_len")
    num_samples = max(batch_size, (num_samples // batch_size) * batch_size)
    starts = rng.integers(0, n - seq_len, size=num_samples)
    windows = np.stack([token_stream[s:s + seq_len] for s in starts]).astype(np.int32)
    for i in range(0, num_samples, batch_size):
        yield windows[i:i + batch_size]
