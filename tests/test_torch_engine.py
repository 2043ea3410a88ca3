"""``Engine.generate`` of the port against the JAX package's Engine (f32
compute and KV cache): equal greedy tokens for ragged and unpadded prompts,
for the float, W8A8, fp8 (dynamic and static) and int4 models; eos and stop
truncation; logprobs (atol 1e-4: the same f32 log-softmax over logits that
agree to ~1e-6). An fp8-static model stays unfused in both engines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.serve import engine as JE
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.serve import engine as TE

from test_torch_util import jax_llama, port_config, port_qcfg, to_numpy_tree

RAGGED = [[5, 9, 1, 77, 3, 8, 100, 12, 40], [7, 7, 2], [300, 1, 2, 3, 4, 5]]
UNPADDED = [[11, 22, 33, 44, 55, 66], [6, 5, 4, 3, 2, 1]]


@pytest.fixture(scope="module", params=["float", "int8"])
def engines(request):
    qkw = {"type": "int8"} if request.param == "int8" else None
    JL, cfg, params, qcfg = jax_llama(qkw, seed=11)
    je = JE.Engine(JL, params, cfg, qcfg, max_batch=4, max_seq=64,
                   kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    te = TE.Engine(TL, params_from_jax(to_numpy_tree(params), device="cpu"),
                   port_config(cfg),
                   port_qcfg(qcfg), max_batch=4, max_seq=64,
                   kv_dtype=torch.float32, compute_dtype=torch.float32,
                   device="cpu")
    return je, te


@pytest.mark.parametrize("prompts", [RAGGED, UNPADDED], ids=["ragged", "unpadded"])
def test_greedy_tokens_equal_jax(engines, prompts):
    je, te = engines
    cfg_j = JE.GenerationConfig(max_new_tokens=10)
    cfg_t = TE.GenerationConfig(max_new_tokens=10)
    assert te.generate(prompts, cfg_t) == je.generate(prompts, cfg_j)


def test_eos_stop_and_logprobs_match_jax(engines):
    je, te = engines
    free = je.generate(RAGGED, JE.GenerationConfig(max_new_tokens=10))
    eos = free[0][3]
    stop = ((free[1][4], free[1][5]),)
    kw = dict(max_new_tokens=10, eos_token_id=eos, stop=stop, return_logprobs=True)
    j = je.generate(RAGGED, JE.GenerationConfig(**kw))
    t = te.generate(RAGGED, TE.GenerationConfig(**kw))
    assert len(t[0][0]) == 3 and len(t[1][0]) <= 4      # eos and stop cut
    for (tt, tl), (jt, jl) in zip(t, j):
        assert tt == jt
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_repetition_penalty_greedy_matches_jax(engines):
    je, te = engines
    kw = dict(max_new_tokens=8, repetition_penalty=1.3)
    assert (te.generate(UNPADDED, TE.GenerationConfig(**kw))
            == je.generate(UNPADDED, JE.GenerationConfig(**kw)))


def test_sampling_is_seeded(engines):
    _, te = engines
    gc = TE.GenerationConfig(max_new_tokens=8, temperature=1.0, top_k=50)
    a = te.generate(UNPADDED, gc, seed=1)
    assert a == te.generate(UNPADDED, gc, seed=1)
    assert a != te.generate(UNPADDED, gc, seed=2)


def test_engine_checks_its_inputs(engines):
    _, te = engines
    with pytest.raises(ValueError, match="max_seq"):
        te.generate([[1] * 60], TE.GenerationConfig(max_new_tokens=10))
    with pytest.raises(ValueError):
        te.generate([[1]] * 5)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg, params, _ = jax_llama(None, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        TE.Engine(TL, params_from_jax(to_numpy_tree(params), device="cpu"),
                  port_config(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(to_numpy_tree(params), port_config(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        TL.init_kv_cache(port_config(cfg), 1, 8)


QUANT = {"fp8": {"type": "fp8_e4m3"},
         "fp8_per_token": {"type": "fp8_e4m3", "qkv": "per-token", "out": "per-token",
                           "fc1": "per-token", "fc2": "per-token"},
         "fp8_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
         "int4": {"type": "int4"}}


@pytest.fixture(scope="module")
def quant_engines(request):
    qkw = QUANT[request.param]
    JL, cfg, params, qcfg = jax_llama(qkw, seed=12)
    je = JE.Engine(JL, params, cfg, qcfg, max_batch=4, max_seq=64,
                   kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    te = TE.Engine(TL, params_from_jax(to_numpy_tree(params), device="cpu"),
                   port_config(cfg), port_qcfg(qcfg), max_batch=4, max_seq=64,
                   kv_dtype=torch.float32, compute_dtype=torch.float32,
                   device="cpu")
    return je, te, request.param


# Ragged prompts with fp8 per-tensor *dynamic* scales are left out on
# purpose: the prefill's one activation scale spans the left-pad rows, which
# the port (banded flash attention: 0) and JAX's eager path (a mean over
# fully masked scores) fill differently by design, so the valid rows
# quantize against different scales. Per-token scales see one row each.
@pytest.mark.parametrize("quant_engines,prompts", [
    ("fp8", UNPADDED), ("fp8_per_token", RAGGED), ("fp8_per_token", UNPADDED),
    ("fp8_static", RAGGED), ("fp8_static", UNPADDED),
    ("int4", RAGGED), ("int4", UNPADDED)], indirect=["quant_engines"],
    ids=["fp8-unpadded", "fp8_per_token-ragged", "fp8_per_token-unpadded",
         "fp8_static-ragged", "fp8_static-unpadded", "int4-ragged", "int4-unpadded"])
def test_greedy_tokens_equal_jax_fp8_int4(quant_engines, prompts):
    je, te, _ = quant_engines
    assert (te.generate(prompts, TE.GenerationConfig(max_new_tokens=10))
            == je.generate(prompts, JE.GenerationConfig(max_new_tokens=10)))


@pytest.mark.parametrize("quant_engines", list(QUANT), indirect=True)
def test_fp8_static_stays_unfused_in_both_engines(quant_engines):
    """Fusing would drop the frozen input scales: both engines keep q/k/v and
    gate/up apart for fp8-static params, and fuse the others."""
    je, te, fmt = quant_engines
    static = fmt == "fp8_static"
    assert ("qkv" in je.params["layers"]["attn"]) != static
    for lp in te.params["layers"]:
        assert ("qkv" in lp["attn"]) != static and ("gateup" in lp["mlp"]) != static
        assert ("input_scale" in lp["attn"]["o"]) == static
