"""Architecture string -> model-family module: the port's copy of
``autosmoothquant_tpu/models/registry.py``, registering only the families
the port has.

A checkpoint's ``config.json`` names its HF ``architectures``; the
reference's quantized checkpoints carry its class names
(``QuantizedLlamaForCausalLM``, ``Int8OPTForCausalLM``), whose prefix is
stripped back to the HF architecture. A config without ``architectures``
is looked up by its ``model_type``. Modules are imported when picked.
"""

from __future__ import annotations

import importlib
from typing import Dict

# HF architecture -> the port's module under models/
MODEL_REGISTRY: Dict[str, str] = {
    "LlamaForCausalLM": "llama",
    "LLaMAForCausalLM": "llama",
    "Qwen2ForCausalLM": "llama",
    "MistralForCausalLM": "llama",
    "GemmaForCausalLM": "gemma",
    "BaichuanForCausalLM": "baichuan",
    "BaiChuanForCausalLM": "baichuan",
    "MixtralForCausalLM": "mixtral",
    "OPTForCausalLM": "opt",
}
# HF model_type -> the same modules, for configs without `architectures`
MODEL_TYPES: Dict[str, str] = {"llama": "llama", "qwen2": "llama",
                               "mistral": "llama", "gemma": "gemma",
                               "baichuan": "baichuan", "mixtral": "mixtral",
                               "opt": "opt"}
_PREFIXES = ("", "Quantized", "Int8")


def _module(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def get_model_family(config):
    """The port's model module (``models.llama``, ``models.gemma``,
    ``models.baichuan``, ``models.mixtral`` or ``models.opt``) for an HF
    config (a dict or an object with ``architectures`` / ``model_type``);
    raises ValueError for an architecture neither package has."""
    g = ((lambda k: config.get(k)) if isinstance(config, dict)
         else (lambda k: getattr(config, k, None)))
    architectures = list(g("architectures") or [])
    for arch in architectures:
        for prefix in _PREFIXES:
            name = arch[len(prefix):] if arch.startswith(prefix) else None
            if name in MODEL_REGISTRY:
                return _module(MODEL_REGISTRY[name])
    model_type = g("model_type")
    if not architectures and model_type in MODEL_TYPES:
        return _module(MODEL_TYPES[model_type])
    raise ValueError(
        f"architectures {architectures} (model_type {model_type!r}) are not "
        f"supported; supported: {sorted(MODEL_REGISTRY)}")
