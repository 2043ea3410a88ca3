"""Read and write the quantized artifact that ``autosmoothquant_tpu``'s
``convert/pipeline.py:save_quantized`` writes (one format, which both
packages read):

  asq_weights.safetensors   every params leaf, keyed by its "/"-joined path
  asq_manifest.json         container metadata
  quant_config.json         the QuantConfig contract
  config.json               the HF model config (optional)

Every format the JAX package writes loads: int8, fp8 (e4m3 dynamic or static,
e5m2; the safetensors codes F8_E4M3 / F8_E5M2) and int4 (packed uint8 with
its group scales). ``save_quantized`` writes the same artifact (manifest
version 2, the safetensors container) from a params tree in the JAX
package's layout (``convert/from_jax.py:params_to_jax`` gives it from the
port's params). The quantize pipeline itself (calibrate, smooth, quantize)
and the reader of the reference's own checkpoints (JAX ``convert/hf.py``)
are not ported yet (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..quant.config import QuantConfig, parse_quant_config, save_quant_config
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
                   config_dict: Optional[dict] = None) -> None:
    """Write the artifact of ``params``, a tree of torch tensors or numpy
    arrays in the JAX package's layout (what ``params_from_jax`` reads; never
    the port's own), with ``qcfg`` and, when given, the HF ``config_dict``:
    ``asq_weights.safetensors``, ``asq_manifest.json`` (version 2, the
    safetensors container), ``quant_config.json`` and ``config.json``."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, _WEIGHTS_ST), flatten(params),
                     metadata={"format": "asq"})
    with open(os.path.join(path, _MANIFEST), "w", encoding="utf-8") as f:
        json.dump({"dtypes": {}, "version": 2, "container": "safetensors"}, f)
    save_quant_config(qcfg, os.path.join(path, "quant_config.json"))
    if config_dict is not None:
        with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
            json.dump(config_dict, f, indent=2)


def load_any_quantized(path: str, *, device="cuda"):
    """``load_quantized`` of a native artifact (``asq_manifest.json``), what
    the CLIs call. A reference-format checkpoint (``quant_config.json`` and
    ``config.json`` without a manifest: the reference's ``save_pretrained``
    output, which JAX ``convert/hf.py`` reads) raises NotImplementedError;
    anything else FileNotFoundError."""
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return load_quantized(path, device=device)
    if all(os.path.exists(os.path.join(path, f)) for f in ("quant_config.json", "config.json")):
        raise NotImplementedError(
            f"{path}: a reference-format checkpoint (quant_config.json + config.json, "
            "no asq_manifest.json); its reader (convert/hf.py) is not ported yet "
            "(ROADMAP Queue 1, item 13)")
    raise FileNotFoundError(
        f"{path}: neither a native quantized artifact ({_MANIFEST}) nor a "
        "reference-format one (quant_config.json + config.json)")
