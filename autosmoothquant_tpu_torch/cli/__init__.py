"""The port's command-line entry points, run as modules on the card:

    python -m autosmoothquant_tpu_torch.cli.smoothquant_model --model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.serve_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.test_model --quantized-model-path DIR ...
    python -m autosmoothquant_tpu_torch.cli.eval_model --model-path DIR --tokenizer-path DIR ...

They take the flags of ``examples/smoothquant_model.py`` (an HF float
checkpoint -> a quantized artifact), ``examples/serve_model.py``,
``examples/test_model.py`` and ``examples/eval_model.py`` (perplexity and
tasks). A flag whose feature the port does not have yet
raises NotImplementedError naming its ROADMAP item; none is ignored.
``test_model --tp N`` runs N ranks and ``eval_model --stages N
--tensor-parallel M`` N x M ranks (``shard/mesh.py:launch``); ``serve_model
--tp`` above 1 is refused (ROADMAP Queue 1, item 17c)."""

from __future__ import annotations


# the flags that ask for a feature not ported yet: (attribute, flag, what, item)
_UNPORTED = (("tp", "--tp", "tensor-parallel serving over HTTP", "17c"),)


def refuse_unported(args, allow=()) -> None:
    """NotImplementedError for a parsed flag that asks for a feature the port
    does not have: ``serve_model --tp`` above 1 (0 or 1 is the one card);
    the attributes in ``allow`` are the caller's own (``test_model`` runs
    ``--tp``)."""
    for attr, flag, what, item in _UNPORTED:
        n = getattr(args, attr, 0)
        if n > 1 and attr not in allow:
            raise NotImplementedError(
                f"{flag} {n}: {what} is not ported yet (ROADMAP Queue 1, item {item}); "
                f"the port runs it on one card ({flag} 0 or 1)")


def load(path: str, device):
    """(family module, family name, config, params, QuantConfig) of the
    quantized checkpoint at ``path``, its params on ``device``."""
    from ..convert.pipeline import load_any_quantized
    from ..models.registry import get_model_family

    params, qcfg, config = load_any_quantized(path, device=device)
    model_mod = get_model_family(config)
    return (model_mod, model_mod.__name__.rsplit(".", 1)[-1],
            model_mod.config_from_hf(config), params, qcfg)
