"""The Llama-family variants that ride ``models/llama.py`` (ROADMAP item 4),
the port against the JAX module on random params: Qwen2's q/k/v biases
(``attention_bias``, drawn with std 0.5), a Mistral sliding window shorter
than the prompt (the eager mask route, and its per-row form in the
continuous engine's decode), and Gemma's gelu-tanh MLP. Each arm: prefill
and one decode step (logits within ``tests/test_torch_llama.py``'s
tolerances: float 1e-5, int8 3e-2), and ``Engine.generate`` greedy on ragged
and unpadded prompts (equal tokens; W8A8 up to a near-tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.serve import engine as JE
from autosmoothquant_tpu.serve.batching import ContinuousEngine as JCE
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.serve import engine as TE
from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine as TCE

from test_torch_util import (jax_llama, one_torch_thread, port_config,  # noqa: F401
                             port_qcfg, run_jax_cached, run_port_cached, to_numpy_tree)

VARIANTS = {"qwen2_bias": dict(attention_bias=True),
            "mistral_window": dict(sliding_window=16),
            "gemma_gelu_tanh": dict(hidden_act="gelu_tanh")}
QUANT = {"float": (None, 1e-5), "int8": ({"type": "int8"}, 3e-2)}
PROMPT = 24  # longer than the window


@pytest.fixture(scope="module")
def variants():
    built = {}

    def get(variant, quant):
        if (variant, quant) not in built:
            JL, cfg, params, qcfg = jax_llama(QUANT[quant][0], seed=31, **VARIANTS[variant])
            built[variant, quant] = (JL, cfg, params, qcfg, port_config(cfg),
                                     params_from_jax(to_numpy_tree(params), device="cpu"),
                                     port_qcfg(qcfg))
        return built[variant, quant]
    return get


@pytest.mark.parametrize("quant", list(QUANT))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_forward_matches_jax(variants, variant, quant):
    JL, cfg, params, qcfg, tcfg, tparams, tq = variants(variant, quant)
    assert getattr(tcfg, next(iter(VARIANTS[variant]))) == next(iter(VARIANTS[variant].values()))
    ids = np.random.default_rng(32).integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JL, cfg, params, qcfg, ids, jnp.float32)
    t_pre, t_dec = run_port_cached(TL, tcfg, tparams, tq, ids, torch.float32, tok)
    tol = QUANT[quant][1]
    np.testing.assert_allclose(t_pre, j_pre, atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


RAGGED = [[5, 9, 1, 77, 3, 8, 100, 12, 40] * 3, [7, 7, 2] * 6, [300, 1, 2, 3, 4, 5]]
UNPADDED = [list(range(11, 11 + PROMPT)), list(range(200, 200 - PROMPT, -1))]


# W8A8 greedy tokens may part only at a near-tie: a step where the JAX
# model's top-2 logit margin is at most this (PERF.md §2's W8A8 rule). A
# last-bit difference (XLA's and PyTorch's gelu-tanh differ by one ulp on a
# third of their values) moves an activation across an int8 rounding
# boundary, which moves these logits by up to ~1e-2
NEAR_TIE = 0.02


def _jax_margin(JL, cfg, params, qcfg, ids):
    h, _, _ = JL.forward_jit(params, jnp.asarray([ids], jnp.int32), cfg, qcfg)
    top = np.sort(np.asarray(JL.logits(params, h))[0, -1])[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("quant", list(QUANT))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_engine_greedy_equals_jax(variants, variant, quant):
    """Equal tokens (float); W8A8 rows equal up to the first near-tie."""
    JL, cfg, params, qcfg, tcfg, tparams, tq = variants(variant, quant)
    je = JE.Engine(JL, params, cfg, qcfg, max_batch=4, max_seq=64,
                   kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    te = TE.Engine(TL, tparams, tcfg, tq, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                   compute_dtype=torch.float32, device="cpu")
    for prompts in (RAGGED, UNPADDED):
        got = te.generate(prompts, TE.GenerationConfig(max_new_tokens=12))
        want = je.generate(prompts, JE.GenerationConfig(max_new_tokens=12))
        if quant == "float":
            assert got == want
            continue
        for prompt, a, b in zip(prompts, got, want):
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None:
                assert _jax_margin(JL, cfg, params, qcfg, prompt + b[:j]) <= NEAR_TIE, (j, a, b)


@pytest.mark.parametrize("chunk", [None, 16])
def test_sliding_window_continuous_engine_equals_jax(variants, chunk):
    """The window's per-row decode mask (each slot its own band) and its
    prefill routes in the continuous engine: JAX's tokens."""
    JL, cfg, params, qcfg, tcfg, tparams, tq = variants("mistral_window", "int8")
    kw = dict(max_batch=2, max_seq=96, steps_per_sync=4, prefill_chunk=chunk)
    je = JCE(JL, params, cfg, qcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    te = TCE(TL, tparams, tcfg, tq, kv_dtype=torch.float32, compute_dtype=torch.float32,
             device="cpu", **kw)
    prompts = [list(range(3, 3 + n)) for n in (40, 5, 21)]
    for e in (je, te):
        for i, p in enumerate(prompts):
            e.submit(i, p, max_new_tokens=20)
    assert te.run() == je.run()
