"""Bridge to the installed ``lm_eval`` package (EleutherAI's
lm-evaluation-harness), the reference's HFLM + simple_evaluate path
(``examples/eval_model.py:107-123``; the port of
``autosmoothquant_tpu/eval/lm_eval_adapter.py``).

Written against lm-evaluation-harness v0.4: an ``lm_eval.api.model.LM``
subclass whose ``loglikelihood`` / ``loglikelihood_rolling`` /
``generate_until`` take ``lm_eval.api.instance.Instance`` lists (``.args`` =
(context, continuation) / (context,) / (context, gen_kwargs)), and
``lm_eval.simple_evaluate(model=, tasks=, num_fewshot=)``. ``lm_eval`` is
imported in the call; without it the call raises ImportError pointing to
the native harness (``eval/harness.py``), which needs no package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .lm_adapter import TorchLM


def run_lm_eval(model_mod, params, cfg, qcfg, tokenizer, *, tasks: Sequence[str],
                num_fewshot: int = 0, batch_size: int = 1,
                max_length: int = 2048, device="cuda") -> Dict:
    try:
        import lm_eval
        from lm_eval.api.model import LM
    except ImportError as e:
        raise ImportError(
            "lm_eval is not installed; use the native harness "
            "(autosmoothquant_tpu_torch.eval.harness.evaluate) or install "
            "lm-evaluation-harness") from e

    tlm = TorchLM(model_mod, params, cfg, qcfg, batch_size=batch_size,
                  max_length=max_length, device=device)

    class _Adapter(LM):
        def __init__(self):
            super().__init__()
            self.tokenizer = tokenizer

        def _enc(self, s: str) -> List[int]:
            return tokenizer(s, add_special_tokens=False).input_ids

        def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
            pairs = []
            for req in requests:
                ctx, cont = req.args
                ctx_toks = self._enc(ctx) if ctx else [tokenizer.bos_token_id or 0]
                pairs.append((ctx_toks, self._enc(cont)))
            return tlm.loglikelihood(pairs)

        def loglikelihood_rolling(self, requests) -> List[float]:
            streams = [self._enc(req.args[0]) for req in requests]
            return tlm.loglikelihood_rolling(
                streams, prefix_token=tokenizer.bos_token_id or 0)

        def generate_until(self, requests) -> List[str]:
            # each request with its own max_gen_toks (the JAX bridge applies
            # the last request's to every request)
            outs = []
            for req in requests:
                ctx, gen_kwargs = req.args
                gen_kwargs = gen_kwargs or {}
                toks = tlm.generate_until(
                    [self._enc(ctx)], max_new_tokens=gen_kwargs.get("max_gen_toks", 128),
                    eos_token_id=tokenizer.eos_token_id,
                    stop_sequences=[self._enc(u) for u in gen_kwargs.get("until", [])])[0]
                outs.append(tokenizer.decode(toks))
            return outs

    return lm_eval.simple_evaluate(
        model=_Adapter(), tasks=list(tasks), num_fewshot=num_fewshot,
        batch_size=batch_size)
