"""The port's command-line entry points, run as modules on the card:

    python -m autosmoothquant_tpu_torch.cli.smoothquant_model --model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.serve_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.test_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.eval_model --model-path DIR --tokenizer-path DIR ...

They take the flags of ``examples/smoothquant_model.py`` (an HF float
checkpoint -> a quantized artifact), ``examples/serve_model.py``,
``examples/test_model.py`` and ``examples/eval_model.py`` (perplexity and
tasks). A flag whose feature the port does not have yet
raises NotImplementedError naming its ROADMAP item; none is ignored."""

from __future__ import annotations


# the flags that ask for more than one card: (attribute, flag, what)
_MULTI_CARD = (("tp", "--tp", "tensor-parallel serving"),
               ("tensor_parallel", "--tensor-parallel", "tensor-parallel evaluation"),
               ("stages", "--stages", "pipeline-parallel evaluation"))


def refuse_unported(args) -> None:
    """NotImplementedError for a parsed flag that asks for a feature the port
    does not have: tensor or pipeline parallelism (``--tp``,
    ``--tensor-parallel`` or ``--stages`` above 1; 0 or 1 is the one
    card)."""
    for attr, flag, what in _MULTI_CARD:
        n = getattr(args, attr, 0)
        if n > 1:
            raise NotImplementedError(
                f"{flag} {n}: {what} is not ported yet (ROADMAP Queue 1, item 17); "
                f"the port runs on one card ({flag} 0 or 1)")


def load(path: str, device):
    """(family module, family name, config, params, QuantConfig) of the
    quantized checkpoint at ``path``, its params on ``device``."""
    from ..convert.pipeline import load_any_quantized
    from ..models.registry import get_model_family

    params, qcfg, config = load_any_quantized(path, device=device)
    model_mod = get_model_family(config)
    return (model_mod, model_mod.__name__.rsplit(".", 1)[-1],
            model_mod.config_from_hf(config), params, qcfg)
