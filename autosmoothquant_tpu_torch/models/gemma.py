"""Gemma family: the llama module with load-time folds (the port of
``autosmoothquant_tpu/models/gemma.py``).

Gemma's deviations from Llama are gone before the forward runs:
  - RMSNorm computes x * (1 + w): the loader stores 1 + w
    (``convert/hf.py:gemma_params_from_state_dict``), so the shared norms
    and the fused add + norm + int8 kernel apply unchanged;
  - the embedding is scaled by sqrt(hidden): folded into embed.w at load
    (the tied lm_head built from the unscaled embedding first);
  - head_dim 256 (gemma-2b, gemma-7b), not hidden / heads:
    ``LlamaConfig.head_dim_override``, which K3 and decode attention take;
  - the gelu-tanh MLP: ``LlamaConfig.hidden_act``.
Everything else (forward, quantize, smooth, serving) is ``models/llama.py``.
"""

from .llama import *  # noqa: F401,F403

FAMILY = "gemma"
