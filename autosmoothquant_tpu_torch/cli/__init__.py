"""The port's command-line entry points, run as modules on the card:

    python -m autosmoothquant_tpu_torch.cli.smoothquant_model --model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.serve_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.test_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.eval_model --model-path DIR --tokenizer-path DIR ...

They take the flags of ``examples/smoothquant_model.py`` (an HF float
checkpoint -> a quantized artifact), ``examples/serve_model.py``,
``examples/test_model.py`` and ``examples/eval_model.py`` (perplexity and
tasks). No flag of theirs is ignored or refused. ``serve_model --tp N``,
``test_model --tp N`` and ``eval_model --stages N --tensor-parallel M`` run
their ranks a process each (``shard/mesh.py``)."""

from __future__ import annotations


def load(path: str, device):
    """(family module, family name, config, params, QuantConfig) of the
    quantized checkpoint at ``path``, its params on ``device``."""
    from ..convert.pipeline import load_any_quantized
    from ..models.registry import get_model_family

    params, qcfg, config = load_any_quantized(path, device=device)
    model_mod = get_model_family(config)
    return (model_mod, model_mod.__name__.rsplit(".", 1)[-1],
            model_mod.config_from_hf(config), params, qcfg)


def rank_devices(world: int, device_type: str) -> list:
    """Each rank's device: the CPU, or the visible cards in turn (a card a
    rank under NCCL, which never takes more ranks than cards)."""
    import torch

    if device_type == "cpu":
        return ["cpu"] * world
    n = torch.cuda.device_count()
    return [f"cuda:{r % n}" for r in range(world)]
