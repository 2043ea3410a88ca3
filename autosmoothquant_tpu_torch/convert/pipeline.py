"""Load the quantized artifact that ``autosmoothquant_tpu``'s
``convert/pipeline.py:save_quantized`` writes:

  asq_weights.safetensors   every params leaf, keyed by its "/"-joined path
  asq_manifest.json         container metadata
  quant_config.json         the QuantConfig contract
  config.json               the HF model config (optional)

Every format the JAX package writes loads: int8, fp8 (e4m3 dynamic or static,
e5m2; the safetensors codes F8_E4M3 / F8_E5M2) and int4 (packed uint8 with
its group scales). The quantize pipeline itself (calibrate, smooth, quantize)
is not ported yet; the port serves artifacts the JAX package wrote.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from ..quant.config import parse_quant_config
from .from_jax import params_from_jax
from .safetensors_io import load_safetensors

_MANIFEST = "asq_manifest.json"
_WEIGHTS_ST = "asq_weights.safetensors"


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
