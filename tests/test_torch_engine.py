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

from test_torch_util import jax_llama, one_torch_thread, port_config, port_qcfg, to_numpy_tree  # noqa: F401

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
    with pytest.raises(ValueError, match="max_new_tokens"):
        te.generate([[1]], TE.GenerationConfig(max_new_tokens=0))


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


# three calls in a row on one engine: ragged (b 3), a longer equal-length
# batch (b 4), a shorter ragged batch (b 2); each reuses the static buffers
# (the KV cache rows, kv_valid, the token and logprob outputs) the last left
SUCCESSIVE = [RAGGED,
              [[9, 8, 7, 6, 5, 4, 3, 2, 1, 10, 11, 12, 13, 14, 15, 16]] * 2
              + [[2] * 16, [400 + i for i in range(16)]],
              [[3, 1, 4], [1, 5, 9, 2, 6]]]


def test_successive_calls_of_different_b_equal_jax(engines):
    je, te = engines
    for prompts, n in zip(SUCCESSIVE, (10, 14, 6)):
        assert (te.generate(prompts, TE.GenerationConfig(max_new_tokens=n))
                == je.generate(prompts, JE.GenerationConfig(max_new_tokens=n)))


def test_eos_stop_logprobs_and_penalty_after_a_longer_call_equal_jax(engines):
    """After a call that filled more cache slots and rows than the next one
    uses, eos and stop truncation, logprobs and the repetition penalty
    still give JAX's results."""
    je, te = engines
    te.generate(SUCCESSIVE[1], TE.GenerationConfig(max_new_tokens=30, repetition_penalty=1.3))
    free = je.generate(RAGGED, JE.GenerationConfig(max_new_tokens=10))
    kw = dict(max_new_tokens=10, eos_token_id=free[0][3],
              stop=((free[1][4], free[1][5]),), return_logprobs=True)
    t = te.generate(RAGGED, TE.GenerationConfig(**kw))
    j = je.generate(RAGGED, JE.GenerationConfig(**kw))
    for (tt, tl), (jt, jl) in zip(t, j):
        assert tt == jt
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    kw = dict(max_new_tokens=8, repetition_penalty=1.3)
    assert (te.generate(RAGGED, TE.GenerationConfig(**kw))
            == je.generate(RAGGED, JE.GenerationConfig(**kw)))


def _engine(params_t, cfg, qcfg, **kw):
    return TE.Engine(TL, params_t, port_config(cfg), port_qcfg(qcfg), max_batch=4,
                     max_seq=64, kv_dtype=torch.float32, compute_dtype=torch.float32,
                     device="cpu", **kw)


@pytest.mark.parametrize("qtype", [None, "int8"], ids=["float", "int8"])
def test_slots_left_by_an_earlier_call_change_nothing(qtype):
    """An engine that served a longer, wider batch first gives a fresh
    engine's tokens and bit-equal last logits: the stale cache slots and
    rows are masked (score -1e30, probability exactly 0)."""
    _, cfg, params, qcfg = jax_llama({"type": qtype} if qtype else None, seed=13)
    params_t = params_from_jax(to_numpy_tree(params), device="cpu")
    fresh, used = _engine(params_t, cfg, qcfg), _engine(params_t, cfg, qcfg)
    used.generate(SUCCESSIVE[1], TE.GenerationConfig(max_new_tokens=40))
    gc = TE.GenerationConfig(max_new_tokens=12)
    for prompts in (SUCCESSIVE[2], RAGGED):
        assert used.generate(prompts, gc) == fresh.generate(prompts, gc)
        assert torch.equal(used.last_logits, fresh.last_logits)


def test_cuda_graph_needs_a_cuda_device():
    _, cfg, params, _ = jax_llama(None, seed=0)
    params_t = params_from_jax(to_numpy_tree(params), device="cpu")
    with pytest.raises(ValueError, match="cuda_graph"):
        _engine(params_t, cfg, None, cuda_graph=True)
    eng = _engine(params_t, cfg, None)
    assert eng.cuda_graph is False and eng.graph_pool is None
    assert eng.kv_cache_bytes == 2 * 2 * 4 * 64 * 2 * 64 * 4  # 2 layers, k and v, f32


def test_graph_key_drops_the_host_only_fields():
    """eos, stop and max_new_tokens do not make a new graph; the sampling
    fields, whose values the captured ops hold, do."""
    key = TE.device_config
    base = key(TE.GenerationConfig())
    assert key(TE.GenerationConfig(max_new_tokens=3, eos_token_id=2, stop=((1, 2),))) == base
    for kw in (dict(temperature=0.8), dict(top_k=5), dict(top_p=0.9),
               dict(repetition_penalty=1.2), dict(return_logprobs=True)):
        assert key(TE.GenerationConfig(**kw)) != base
