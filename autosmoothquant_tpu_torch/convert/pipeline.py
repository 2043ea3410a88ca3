"""The offline quantization pipeline, and the quantized artifact that
``autosmoothquant_tpu``'s ``convert/pipeline.py:save_quantized`` writes (one
format, which both packages read).

``calibrate_smooth_quantize`` is the reference CLI's flow (JAX
``convert/pipeline.py:29-147``): calibrate the float model, smooth it,
calibrate the smoothed model (int8) or observe it through its fp8-quantized
forward (fp8 e4m3 static), then quantize; all after the first pass is
``quantize_from_stats``, which the smoothquant_model CLI also runs. The
artifact:

  asq_weights.safetensors   every params leaf, keyed by its "/"-joined path
  asq_manifest.json         container metadata
  quant_config.json         the QuantConfig contract
  config.json               the HF model config (optional)

Every format the JAX package writes loads: int8, fp8 (e4m3 dynamic or static,
e5m2; the safetensors codes F8_E4M3 / F8_E5M2) and int4 (packed uint8 with
its group scales). ``save_quantized`` writes the same artifact (manifest
version 2, the safetensors container) from a params tree in the JAX
package's layout (``convert/from_jax.py:params_to_jax`` gives it from the
port's params). ``load_any_quantized`` also reads the reference's own
quantized checkpoints (``convert/hf.py:load_reference_quantized``).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..calibrate.calibrate import calibrate
from ..quant.config import QuantConfig, parse_quant_config, save_quant_config
from ..quant.ignore import DEFAULT_IGNORE, match_ignore_patterns
from .from_jax import params_from_jax
from .safetensors_io import load_safetensors, save_safetensors

_MANIFEST = "asq_manifest.json"
_WEIGHTS_ST = "asq_weights.safetensors"


def flatten(tree, prefix=()) -> Dict[str, Any]:
    """{"/"-joined path: leaf} of a nested dict (None leaves dropped)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, prefix + (str(k),)))
    elif tree is not None:
        out["/".join(prefix)] = tree
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def read_artifact(path: str) -> Dict[str, Any]:
    """The artifact's flat {path: CPU tensor} map, exactly as stored."""
    with open(os.path.join(path, _MANIFEST), "r", encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("container") != "safetensors":
        raise ValueError(f"{path}: only the safetensors container is read "
                         f"(manifest says {manifest.get('container')!r})")
    return load_safetensors(os.path.join(path, _WEIGHTS_ST))


def load_quantized(path: str, *, device="cuda"):
    """Returns (params, QuantConfig, config_dict-or-None), with params in the
    port's layout on ``device`` (see ``convert/from_jax.py``). The family is
    picked from ``config.json`` by ``models/registry.py`` and its config
    built by that family's ``config_from_hf``; the caller serves with the
    same module (``get_model_family(config_dict)``)."""
    from ..models.registry import get_model_family
    from ..runtime import resolve_device

    dev = resolve_device(device)
    tree = unflatten(read_artifact(path))
    qcfg = parse_quant_config(os.path.join(path, "quant_config.json"))
    cfg_path = os.path.join(path, "config.json")
    config_dict = None
    cfg = None
    if os.path.exists(cfg_path):
        with open(cfg_path, "r", encoding="utf-8") as f:
            config_dict = json.load(f)
        cfg = get_model_family(config_dict).config_from_hf(config_dict)
    return params_from_jax(tree, cfg, device=dev), qcfg, config_dict


def save_quantized(path: str, params, qcfg: QuantConfig,
                   config_dict: Optional[dict] = None,
                   artifacts: Optional[dict] = None) -> None:
    """Write the artifact of ``params``, a tree of torch tensors or numpy
    arrays in the JAX package's layout (what ``params_from_jax`` reads; never
    the port's own), with ``qcfg`` and, when given, the HF ``config_dict``:
    ``asq_weights.safetensors``, ``asq_manifest.json`` (version 2, the
    safetensors container), ``quant_config.json`` and ``config.json``; and
    ``layer_scales.json`` where ``artifacts`` (``calibrate_smooth_quantize``'s)
    holds layer scales."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, _WEIGHTS_ST), flatten(params),
                     metadata={"format": "asq"})
    with open(os.path.join(path, _MANIFEST), "w", encoding="utf-8") as f:
        json.dump({"dtypes": {}, "version": 2, "container": "safetensors"}, f)
    save_quant_config(qcfg, os.path.join(path, "quant_config.json"))
    if config_dict is not None:
        with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
            json.dump(config_dict, f, indent=2)
    if artifacts is not None and artifacts.get("layer_scales") is not None:
        scales = {k: np.asarray(torch.as_tensor(v).cpu()).tolist()
                  for k, v in artifacts["layer_scales"].items()}
        with open(os.path.join(path, "layer_scales.json"), "w", encoding="utf-8") as f:
            json.dump(scales, f)


def load_any_quantized(path: str, *, device="cuda"):
    """(params, QuantConfig, config_dict) of a quantized checkpoint in
    either format, with params in the port's layout on ``device``: a native
    artifact (``asq_manifest.json``: ``load_quantized``) or a reference
    checkpoint (``quant_config.json`` and ``config.json`` without a
    manifest: the reference's ``save_pretrained`` output, through
    ``convert/hf.py:load_reference_quantized``). What the CLIs call;
    anything else raises FileNotFoundError."""
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return load_quantized(path, device=device)
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(os.path.join(path, "quant_config.json")) and os.path.exists(cfg_path):
        from ..models.registry import get_model_family
        from .hf import load_reference_quantized

        with open(cfg_path, "r", encoding="utf-8") as f:
            config = json.load(f)
        family = get_model_family(config).__name__.rsplit(".", 1)[-1]
        params, qcfg = load_reference_quantized(path, family, config["num_hidden_layers"],
                                                device=device)
        return params, qcfg, config
    raise FileNotFoundError(
        f"{path}: neither a native quantized artifact ({_MANIFEST}) nor a "
        "reference-format one (quant_config.json + config.json)")


# ---------------------------------------------------------------------------
# calibrate -> smooth -> (calibrate again) -> quantize
# ---------------------------------------------------------------------------


def resolve_ignore_keys(model_mod, cfg, patterns) -> frozenset:
    """The projection keys (of the family's HF_PROJ_NAMES) that the fp8
    ignore patterns exempt: a pattern must match a projection in every layer
    or in none (a partial match raises ValueError, as in the JAX package,
    whose stacked layers cannot hold one). The lm_head is never quantized,
    so the default "re:.*lm_head" resolves to nothing."""
    if not patterns:
        return frozenset()
    n = cfg.num_hidden_layers
    fmt = getattr(model_mod, "HF_LAYER_FMT", "model.layers.{i}")
    ignored = set()
    for key, suffix in model_mod.HF_PROJ_NAMES.items():
        hits = match_ignore_patterns([f"{fmt.format(i=i)}.{suffix}" for i in range(n)],
                                     patterns)
        if len(hits) == n:
            ignored.add(key)
        elif hits:
            raise ValueError(
                f"ignore pattern matches {len(hits)}/{n} layers of '{suffix}'; "
                "per-layer exemptions are not supported — match all layers or none")
    return frozenset(ignored)


def calibrate_smooth_quantize(model_mod, params, cfg, qcfg: QuantConfig, batches_fn,
                              alpha: float = 0.5, compute_dtype=torch.float32,
                              ignore_patterns=DEFAULT_IGNORE,
                              quantize_output: bool = False):
    """Quantize float ``params`` (the port's layout, on the device the work
    runs on). ``batches_fn``: a zero-argument callable returning a fresh
    iterable of token id batches [B, T] (two passes read them). Returns
    (quantized params, artifacts): the statistics of each pass (host
    tensors), the layer scales, the observer scales, the ignored projections
    and alpha.

    The statistics of the float model (with the family's
    ``CALIBRATION_FORWARD_KWARGS``, if it has any), then
    ``quantize_from_stats``."""
    calib_kwargs = getattr(model_mod, "CALIBRATION_FORWARD_KWARGS", None)
    stats_fp = calibrate(model_mod, params, cfg, batches_fn(), compute_dtype=compute_dtype,
                         extra_forward_kwargs=calib_kwargs)
    qparams, artifacts = quantize_from_stats(
        model_mod, params, stats_fp, cfg, qcfg, batches_fn, alpha, compute_dtype,
        ignore_patterns, quantize_output)
    return qparams, {"act_stats_fp": stats_fp, **artifacts}


def quantize_from_stats(model_mod, params, stats, cfg, qcfg: QuantConfig, batches_fn,
                        alpha: float = 0.5, compute_dtype=torch.float32,
                        ignore_patterns=DEFAULT_IGNORE, quantize_output: bool = False,
                        on_stage=None):
    """Quantize float ``params`` from ``stats``, the float model's
    statistics (host or device tensors, or numpy arrays: the smoothquant_model
    CLI's scales pickle). Returns (quantized params, artifacts): the second
    pass's statistics, the layer scales, the observer scales, the ignored
    projections and alpha.

    ``smooth`` (with ``cfg``: a post-LN OPT is left as it is); then for int8
    the statistics of the smoothed model and its ``layer_scales``; for fp8
    e4m3 static an observer pass through the smoothed model quantized to fp8
    e4m3 dynamic (``fp8_observer_scales``); other formats quantize the
    smoothed model as it is. fp8 leaves the projections the ignore patterns
    name float. ``on_stage(name)``, when given, is a context manager around
    each stage: "smooth", "calibrate_smoothed" or "calibrate_observer", and
    "quantize"."""
    stage = on_stage or (lambda name: contextlib.nullcontext())
    with stage("smooth"):
        smoothed = model_mod.smooth(params, stats, alpha, cfg=cfg)
    is_fp8 = qcfg.type in ("fp8_e4m3", "fp8_e5m2")
    ignore = resolve_ignore_keys(model_mod, cfg, ignore_patterns) if is_fp8 else frozenset()
    scales = stats_sm = observer_scales = None
    if qcfg.is_int8:
        with stage("calibrate_smoothed"):
            stats_sm = calibrate(model_mod, smoothed, cfg, batches_fn(),
                                 compute_dtype=compute_dtype)
        with stage("quantize"):
            scales = model_mod.layer_scales(stats_sm)
            qparams = model_mod.quantize(smoothed, qcfg, scales, cfg=cfg)
    elif qcfg.type == "fp8_e4m3" and qcfg.activation_scheme == "static":
        dyn_cfg = QuantConfig(type="fp8_e4m3", activation_scheme="dynamic")
        dyn_params = model_mod.quantize(smoothed, dyn_cfg, None, cfg=cfg, ignore=ignore)
        with stage("calibrate_observer"):
            stats_sm = calibrate(model_mod, dyn_params, cfg, batches_fn(),
                                 compute_dtype=compute_dtype, qcfg=dyn_cfg)
        del dyn_params
        with stage("quantize"):
            observer_scales = model_mod.fp8_observer_scales(stats_sm)
            scales = model_mod.layer_scales(stats_sm)
            qparams = model_mod.quantize(smoothed, qcfg, scales, cfg=cfg, ignore=ignore,
                                         quantize_output=quantize_output,
                                         observer_scales=observer_scales)
    else:
        with stage("quantize"):
            qparams = model_mod.quantize(smoothed, qcfg, None, cfg=cfg, ignore=ignore)
    artifacts = {"act_stats_smoothed": stats_sm, "layer_scales": scales,
                 "observer_scales": observer_scales, "ignored_projections": sorted(ignore),
                 "alpha": alpha}
    return qparams, artifacts
