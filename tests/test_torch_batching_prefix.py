"""The port's ``ContinuousEngine`` against the JAX package's (as in
``tests/test_torch_batching.py``) on the request sets of
``tests/test_prefix_cache.py`` and the non-paged, non-draft, non-HTTP cases
of ``test_serving_hardening.py``; then what is the port's own: the scratch
slot of parked rows, seeded sampling, and the refusals of what is not
ported."""

import pytest
import torch

from autosmoothquant_tpu_torch.serve import batching as TB
from autosmoothquant_tpu_torch.serve import engine as TE

from test_torch_util import (ARMS, KV, MAX_SEQ, batching_models,  # noqa: F401
                             one_torch_thread, pair, port, prompts_of, run_both)


@pytest.fixture(scope="module")
def models():
    return batching_models()


# tests/test_prefix_cache.py, at max_seq 128
SYSTEM = prompts_of(7, [100])[0]
SUFFIXES = [prompts_of(i, [4 + 3 * i])[0] for i in range(4)]


@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("arm", ARMS)
def test_prefix_outputs_match_jax_and_full_prefill(models, arm, chunk):
    reqs = [(i, SYSTEM + s, dict(max_new_tokens=6)) for i, s in enumerate(SUFFIXES)]
    base_j, base_t = pair(models, arm, max_batch=4, prefill_chunk=chunk)
    want = run_both(base_j, base_t, reqs)
    je, te = pair(models, arm, max_batch=4, prefill_chunk=chunk)
    for e in (je, te):
        e.register_prefix("sys", SYSTEM)
    got = run_both(je, te, [(i, p, dict(kw, prefix="sys")) for i, p, kw in reqs])
    assert got == want
    assert te.prefill_tokens_processed < base_t.prefill_tokens_processed


def test_prefix_only_prompt(models):
    je, te = pair(models, "int8", max_batch=4)
    for e in (je, te):
        e.register_prefix("sys", SYSTEM)
    got = run_both(je, te, [(0, SYSTEM, dict(max_new_tokens=6, prefix="sys"))])
    assert te.prefill_tokens_processed == len(SYSTEM)  # the registration only
    base = port(models, "int8", max_batch=4)
    base.submit(0, SYSTEM, max_new_tokens=6)
    assert base.run() == got


def test_mixed_prefix_and_plain_batch(models):
    je, te = pair(models, "float", max_batch=4)
    for e in (je, te):
        e.register_prefix("sys", SYSTEM)
    got = run_both(je, te, [(0, SYSTEM + SUFFIXES[0], dict(max_new_tokens=5, prefix="sys")),
                            (1, [9, 8, 7, 6, 5], dict(max_new_tokens=5))])
    base = port(models, "float", max_batch=4)
    base.submit(0, SYSTEM + SUFFIXES[0], max_new_tokens=5)
    base.submit(1, [9, 8, 7, 6, 5], max_new_tokens=5)
    assert base.run() == got


def test_unknown_or_mismatched_prefix_falls_back(models):
    je, te = pair(models, "float", max_batch=4)
    for e in (je, te):
        e.register_prefix("sys", SYSTEM)
    got = run_both(je, te, [(0, [1, 2, 3, 4], dict(max_new_tokens=4, prefix="sys")),
                            (1, SYSTEM[:8], dict(max_new_tokens=4, prefix="nope"))])
    base = port(models, "float", max_batch=4)
    base.submit(0, [1, 2, 3, 4], max_new_tokens=4)
    base.submit(1, SYSTEM[:8], max_new_tokens=4)
    assert base.run() == got


def test_drop_prefix_and_lru_eviction(models):
    te = port(models, "float", max_batch=4, max_prefixes=2)
    te.register_prefix("sys", SYSTEM)
    te.drop_prefix("sys")
    te.submit(0, SYSTEM + SUFFIXES[0], max_new_tokens=4, prefix="sys")
    assert len(te.run()[0]) == 4
    # at max_prefixes the least recently used entry goes
    te.register_prefix("a", SYSTEM[:10])
    te.register_prefix("b", SYSTEM[:20])
    te.submit(1, SYSTEM[:10] + [5], max_new_tokens=2, prefix="a")  # a hit refreshes "a"
    te.run()
    te.register_prefix("c", SYSTEM[:30])
    assert set(te._prefixes) == {"a", "c"}
    with pytest.raises(ValueError, match="max_seq"):
        te.register_prefix("d", [1] * MAX_SEQ)
    full = TB.ContinuousEngine(te.model, te.params, te.cfg, te.qcfg, max_seq=MAX_SEQ,
                               max_prefixes=1, kv_dtype=torch.float32, device="cpu",
                               compute_dtype=torch.float32)
    full.register_prefix("a", [1, 2])
    full._prefix_lru.clear()  # nothing evictable
    with pytest.raises(TB.PrefixCacheFull):
        full.register_prefix("b", [3, 4])


# the non-paged, non-draft, non-HTTP cases of tests/test_serving_hardening.py


def test_cancel_sets_done_wherever_the_request_sits(models):
    te = port(models, "float", max_batch=2, prefill_chunk=16)
    a = te.submit("a", [1, 2, 3], max_new_tokens=50)
    adm = te.submit("adm", prompts_of(4, [60])[0], max_new_tokens=4)
    w = te.submit("w", [4, 5, 6], max_new_tokens=4)   # queued behind both
    te.step()
    assert te.slot_req[0] is a and 1 in te._admitting and te.waiting == [w]
    assert te.cancel("w") and w.done and not te.waiting
    assert te.cancel("adm") and adm.done and not te._admitting
    assert te.cancel("a") and a.done and te.slot_req == [None, None]
    assert not te.cancel("a")
    r = te.submit("r", [1, 2], max_new_tokens=4)
    te.reset_slots()
    assert r.done and not te.waiting
    ok = te.submit("ok", [1, 2, 3], max_new_tokens=4)
    te.run()
    assert ok.done and len(ok.output) == 4


def test_submit_boundary_validation(models):
    te = port(models, "float")
    vocab = te.cfg.vocab_size
    with pytest.raises(ValueError, match="non-empty"):
        te.submit("e", [], max_new_tokens=4)
    with pytest.raises(ValueError, match="token ids"):
        te.submit("big", [vocab + 5], max_new_tokens=4)
    with pytest.raises(ValueError, match="token ids"):
        te.submit("neg", [-1, 2], max_new_tokens=4)
    with pytest.raises(ValueError, match="stop"):
        te.submit("s", [1, 2], stop=[1, 2])
    r = te.submit("ok", [1, 2, 3], max_new_tokens=4)
    te.run()
    assert r.done and len(r.output) == 4


# what is the port's own


@pytest.mark.parametrize("kv", KV)
def test_a_parked_rows_cache_is_untouched_by_a_decode_tick(models, kv):
    """While a row prefills in chunks, the decode tick of the other rows
    writes that row's K/V at the scratch slot max_seq (JAX's out-of-bounds
    sentinel, whose write JAX drops): the bytes of its max_seq real slots
    are unchanged, and the other row advances."""
    te = port(models, "int8", kv=kv, steps_per_sync=4, prefill_chunk=16)
    a = te.submit("a", [5, 6, 7], max_new_tokens=30)
    te.step()
    te.submit("b", prompts_of(5, [60])[0], max_new_tokens=4)
    te._admit()
    te._advance_prefills()
    (row,) = te._admitting
    assert 0 < te._admitting[row]["pos"] < 60
    before = [t[row].clone() for layer in te.pool for t in TE._tensors(layer)]
    n = len(a.output)
    te._decode_tick()
    after = [t[row] for layer in te.pool for t in TE._tensors(layer)]
    assert len(a.output) > n
    assert all(torch.equal(x[:MAX_SEQ], y[:MAX_SEQ]) for x, y in zip(before, after))
    assert not all(torch.equal(x[MAX_SEQ], y[MAX_SEQ]) for x, y in zip(before, after))


def test_same_seed_gives_the_same_sampled_tokens(models):
    def run(seed):
        te = port(models, "int8", max_batch=3, steps_per_sync=4, seed=seed)
        te.submit("g", [1, 2, 3], max_new_tokens=8)
        te.submit("s", [4, 5, 6, 7], max_new_tokens=12, temperature=1.0, top_k=40)
        te.submit("p", [9] * 5, max_new_tokens=12, temperature=0.8, top_p=0.9,
                  repetition_penalty=1.3, want_logprobs=True)
        return te.run()
    a = run(3)
    assert a == run(3) and a != run(4)
    je = pair(models, "int8", max_batch=3, steps_per_sync=4)[0]
    je.submit("g", [1, 2, 3], max_new_tokens=8)
    assert a["g"] == je.run()["g"]  # the greedy row of a sampled batch


def test_penalized_greedy_and_logprobs_match_jax(models):
    reqs = [("p", [9, 9, 4, 9, 2], dict(max_new_tokens=12, repetition_penalty=1.3,
                                         want_logprobs=True)),
            ("q", [3, 1, 4], dict(max_new_tokens=9))]
    run_both(*pair(models, "int8", steps_per_sync=4), reqs)


def _stage_mesh(index=0):
    """Rank ``index``'s mesh with a stage axis of 2 (pipeline stages), built
    without process groups: the engine's construction shards and allocates,
    and runs no collective."""
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh

    return layout_mesh(stage=2, rank=index)


@pytest.mark.parametrize("kw", [dict(), dict(param_shardings={})],
                         ids=["mesh", "param_shardings"])
def test_what_is_not_ported_raises(models, kw):
    """A stage mesh builds an engine (with the family's specs, or with
    ``param_shardings`` led by "stage"): each rank holds its stage's layers
    and their pool, the first stage the embedding, the last the head. Specs
    without "stage" are refused under a stage mesh."""
    from autosmoothquant_tpu_torch.shard.sharding import llama_param_specs, with_stage_axis

    *_, TM, tcfg, tparams, (_, tq) = models("float")
    n = tcfg.num_hidden_layers
    for index in (0, 1):
        mesh = _stage_mesh(index)
        if "param_shardings" in kw:
            kw = {"param_shardings": with_stage_axis(llama_param_specs(tcfg, mesh), mesh, n)}
        eng = TB.ContinuousEngine(TM, tparams, tcfg, tq, device="cpu", mesh=mesh, **kw)
        assert len(eng.params["layers"]) == len(eng.pool) == n // 2
        assert ("embed" in eng.params) == (index == 0)
        assert ("lm_head" in eng.params) == (index == 1)
    with pytest.raises(ValueError, match="with_stage_axis"):
        TB.ContinuousEngine(TM, tparams, tcfg, tq, device="cpu", mesh=_stage_mesh(),
                            param_shardings=llama_param_specs(tcfg, _stage_mesh()))


@pytest.mark.parametrize("arg", ["draft", "speculative_gamma"])
def test_speculative_arguments_serve(models, arg):
    """``draft`` (the target itself as its draft model) and
    ``speculative_gamma`` build a speculative engine whose greedy tokens are
    the plain engine's, with a pool of max_seq + gamma + 1 slots."""
    from autosmoothquant_tpu_torch.serve.engine import DraftModel

    *_, TM, tcfg, tparams, (_, tq) = models("float")
    kw = dict(max_batch=2, max_seq=MAX_SEQ, kv_dtype=torch.float32,
              compute_dtype=torch.float32, device="cpu")
    spec = dict(speculative_gamma=3)
    if arg == "draft":
        spec["draft"] = DraftModel(TM, tparams, tcfg, tq)
    prompts = [[7, 8, 9, 10] * 4, [3, 1, 4, 1, 5]]
    outs = []
    for extra in ({}, spec):
        te = TB.ContinuousEngine(TM, tparams, tcfg, tq, **kw, **extra)
        for i, p in enumerate(prompts):
            te.submit(i, p, max_new_tokens=12)
        outs.append(te.run())
    assert outs[1] == outs[0]
    assert te.pool[0].k.shape[1] == MAX_SEQ + 4
    assert (te.dpool is not None) == (arg == "draft")


def test_default_device_and_graphs_need_a_card(models):
    *_, TM, tcfg, tparams, (_, tq) = models("float")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TB.ContinuousEngine(TM, tparams, tcfg, tq)
    with pytest.raises(ValueError, match="cuda_graph"):
        TB.ContinuousEngine(TM, tparams, tcfg, tq, device="cpu", cuda_graph=True)
    te = TB.ContinuousEngine(TM, tparams, tcfg, tq, max_batch=2, max_seq=MAX_SEQ,
                             kv_dtype=torch.float32, device="cpu")
    assert te.cuda_graph is False and te.graph_pool is None and te.graphs == {}
    # the pool holds one scratch slot past max_seq
    assert te.pool[0].k.shape[:2] == (2, MAX_SEQ + 1)
