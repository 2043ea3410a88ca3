"""The port's ``ContinuousEngine`` against the JAX package's, on the same
params (``params_from_jax``) at TINY width, f32 compute and KV, for float and
W8A8 Llama and W8A8 OPT: equal greedy outputs, equal
``prefill_tokens_processed`` and ``decode_tokens_generated``, and logprobs
within atol 1e-4 (the f32 log-softmax of logits that agree to ~1e-6, as
``tests/test_torch_engine.py`` holds them), on the request sets of
``tests/test_continuous_batching.py`` and ``test_chunked_prefill.py`` and
the exact chunked token counter of ``test_serving_hardening.py``
(``test_torch_batching_prefix.py`` holds the prefix cache and the rest)."""

import pytest
import torch

from autosmoothquant_tpu_torch.serve import engine as TE

from test_torch_util import (ARMS, MAX_SEQ, batching_models, one_torch_thread,  # noqa: F401
                             pair, port, prompts_of, run_both)


@pytest.fixture(scope="module")
def models():
    return batching_models()


# the request sets of tests/test_continuous_batching.py: (engine kwargs,
# [(uid, prompt, submit kwargs)]). Most run at max_batch 2 and
# steps_per_sync 4, so that one JAX engine (one set of compiles) serves them;
# "ragged_budgets" keeps 5 (rounded down to 4 steps a tick)
SETS = {
    "single": (dict(steps_per_sync=4),
               [("a", [3, 1, 4, 1, 5, 9, 2, 6], dict(max_new_tokens=10, want_logprobs=True))]),
    "oversubscribed": (dict(steps_per_sync=4),
                       [(f"r{i}", [i + 1, (2 * i) % 250 + 1, 7, i % 11 + 1],
                         dict(max_new_tokens=6)) for i in range(5)]),
    "ragged_budgets": (dict(max_batch=3, steps_per_sync=5),
                       [("x", [5] * 3, dict(max_new_tokens=4)),
                        ("y", [9] * 17, dict(max_new_tokens=9, want_logprobs=True)),
                        ("z", [2, 8], dict(max_new_tokens=13))]),
    "capacity_clamp": (dict(max_batch=4, max_seq=64, steps_per_sync=8),
                       [("a", [1, 2, 3], dict(max_new_tokens=10)),
                        ("near_cap", list(range(1, 51)), dict(max_new_tokens=40)),
                        ("long", list(range(1, 80)), dict(max_new_tokens=10))]),
}


@pytest.mark.parametrize("case", list(SETS))
@pytest.mark.parametrize("arm", ARMS)
def test_request_sets_match_jax(models, arm, case):
    kw, reqs = SETS[case]
    got = run_both(*pair(models, arm, **kw), reqs)
    for uid, _, skw in reqs:
        if case != "capacity_clamp":
            assert len(got[uid]) == skw["max_new_tokens"]
    if case == "capacity_clamp":
        # 50-token prompt: the prefill token + 13 decode writes (slots
        # 50..62); 79 tokens are trimmed to 63, retired after the first
        assert [len(got[u]) for u in ("a", "near_cap", "long")] == [10, 14, 1]


@pytest.mark.parametrize("arm", ARMS)
def test_single_request_matches_the_static_engine(models, arm):
    JM, cfg, params, TM, tcfg, tparams, (_, tq) = models(arm)
    te = port(models, arm, steps_per_sync=4)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    te.submit("a", prompt, max_new_tokens=10)
    static = TE.Engine(TM, tparams, tcfg, tq, max_batch=1, max_seq=MAX_SEQ,
                       kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")
    assert te.run()["a"] == static.generate([prompt], TE.GenerationConfig(max_new_tokens=10))[0]


@pytest.mark.parametrize("arm", ARMS)
def test_eos_stops_early_as_jax(models, arm):
    je, te = pair(models, arm, steps_per_sync=4)
    prompt = [5, 9, 1, 77, 3, 8]
    full = run_both(je, te, [("f", prompt, dict(max_new_tokens=10))])["f"]
    # the first token at step >= 2 not emitted before it: eos there
    idx = next(i for i in range(2, len(full)) if full[i] not in full[:i])
    stop = full[idx - 2:idx]
    out = run_both(je, te, [("e", prompt, dict(max_new_tokens=10, eos_token_id=full[idx])),
                            ("s", prompt, dict(max_new_tokens=10, stop=[stop]))])
    assert out["e"] == full[:idx] and out["s"] == full[:idx - 2]


@pytest.mark.parametrize("arm", ARMS)
def test_int8_kv_pool_matches_jax(models, arm):
    got = run_both(*pair(models, arm, kv="int8", steps_per_sync=4),
                   [("q", [1, 2, 3, 4], dict(max_new_tokens=6, want_logprobs=True))])
    assert len(got["q"]) == 6


# tests/test_chunked_prefill.py, at max_seq 128
@pytest.mark.parametrize("chunk", [None, 8, 16])
@pytest.mark.parametrize("arm", ARMS)
def test_chunked_prefill_matches_jax(models, arm, chunk):
    c = chunk or 16
    lp = prompts_of(0, [90, 3, c, c + 7])
    reqs = [(uid, p, dict(max_new_tokens=8)) for uid, p in zip(
        ("long", "short", "exact", "ragged"), lp)]
    got = run_both(*pair(models, arm, steps_per_sync=4, prefill_chunk=chunk), reqs)
    if chunk is not None:
        whole = port(models, arm, steps_per_sync=4)
        for uid, p, kw in reqs:
            whole.submit(uid, p, **kw)
        assert whole.run() == got


def test_decode_proceeds_during_admission(models):
    """A long prompt admitted in chunks while another slot decodes: the
    decoding slot gains tokens during the admission ticks, and both
    outputs are the JAX unchunked engine's."""
    long_prompt = prompts_of(1, [100])[0]
    short = [7, 3, 11]
    te = port(models, "int8", steps_per_sync=2, prefill_chunk=16)
    r_short = te.submit("short", short, max_new_tokens=16)
    te.step()
    r_long = te.submit("long", long_prompt, max_new_tokens=8)
    progress = []
    for _ in range(6):
        before = len(r_short.output)
        te.step()
        progress.append(len(r_short.output) - before)
    assert sum(progress[:4]) > 0 and te._admitting
    te.run()
    je = pair(models, "int8", steps_per_sync=4)[0]
    je.submit("short", short, max_new_tokens=16)
    je.submit("long", long_prompt, max_new_tokens=8)
    ref = je.run()
    assert r_short.output == ref["short"] and r_long.output == ref["long"]


@pytest.mark.parametrize("arm", ["int8", "opt_int8"])
def test_chunked_int8_kv_matches_jax(models, arm):
    reqs = [(uid, p, dict(max_new_tokens=6)) for uid, p in zip(
        ("a", "b"), prompts_of(2, [100, 3]))]
    run_both(*pair(models, arm, kv="int8", steps_per_sync=4, prefill_chunk=16), reqs)


@pytest.mark.parametrize("arm", ["float", "opt_int8"])
def test_chunked_prefill_token_counter_exact(models, arm):
    """The ragged final chunk's overlap re-feed counts each token once."""
    je, te = pair(models, arm, prefill_chunk=64)
    run_both(je, te, [("x", list(range(1, 101)), dict(max_new_tokens=2))])
    assert te.prefill_tokens_processed == 100
