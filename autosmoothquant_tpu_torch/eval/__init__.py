"""Evaluation on the card: perplexity (``ppl``), the LM adapter over the
port's model families (``lm_adapter.TorchLM``), the native harness and its
JSON-lines tasks (``harness``, ``tasks``), the lm-evaluation-harness bridge
(``lm_eval_adapter``) and a worked custom metric (``custom_metrics``)."""

from .ppl import perplexity, perplexity_from_tokens

__all__ = ["perplexity", "perplexity_from_tokens"]
