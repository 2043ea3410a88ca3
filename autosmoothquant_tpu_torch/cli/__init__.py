"""The port's command-line entry points, run as modules on the card:

    python -m autosmoothquant_tpu_torch.cli.smoothquant_model --model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.serve_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.test_model --quantized-model-path DIR ...

They take the flags of ``examples/smoothquant_model.py`` (an HF float
checkpoint -> a quantized artifact), ``examples/serve_model.py`` and
``examples/test_model.py``. A flag whose feature the port does not have yet
raises NotImplementedError naming its ROADMAP item; none is ignored."""

from __future__ import annotations


def refuse_unported(args) -> None:
    """NotImplementedError for each parsed flag that asks for a feature the
    port does not have: tensor parallelism (``--tp`` > 1), speculative
    decoding (``--speculative-gamma`` > 0) and the paged engine's automatic
    prefix sharing (``--paged`` without ``--no-auto-prefix``, the JAX CLI's
    default). ``--tp`` 0 or 1 is the one card; ``--paged --no-auto-prefix``
    serves the paged engine with explicit prefixes."""
    if args.tp > 1:
        raise NotImplementedError(
            f"--tp {args.tp}: tensor-parallel serving is not ported yet "
            "(ROADMAP Queue 1, item 17); the port serves on one card (--tp 0 or 1)")
    if args.speculative_gamma > 0:
        raise NotImplementedError(
            f"--speculative-gamma {args.speculative_gamma}: speculative decoding is "
            "not ported yet (ROADMAP Queue 1, item 14)")
    if getattr(args, "paged", False) and not getattr(args, "no_auto_prefix", False):
        raise NotImplementedError(
            "--paged: the paged engine's automatic prefix radix tree (on by default) is "
            "not ported yet (ROADMAP Queue 1, item 8b); add --no-auto-prefix for the "
            "paged engine with explicit prefixes")


def load(path: str, device):
    """(family module, family name, config, params, QuantConfig) of the
    quantized checkpoint at ``path``, its params on ``device``."""
    from ..convert.pipeline import load_any_quantized
    from ..models.registry import get_model_family

    params, qcfg, config = load_any_quantized(path, device=device)
    model_mod = get_model_family(config)
    return (model_mod, model_mod.__name__.rsplit(".", 1)[-1],
            model_mod.config_from_hf(config), params, qcfg)
