"""The port's engines over a mesh (``serve/engine.py``, ``serve/batching.py``,
``serve/paged.py`` with ``mesh=``), ``serve/multihost.py`` and ``test_model
--tp``, against the JAX package's sharded engines on the same mesh and
against the port on one rank (JAX ``tests/test_serve_sharded.py``,
``tests/test_multihost_serve.py``).

The port's ranks are spawned gloo processes on the CPU
(``shard/mesh.py:launch``): one launch of 2 ranks and one of 4 run every
engine case, and each test reads its case's tokens. The JAX engines run on
the conftest's 8 virtual devices. Each rank imports torch and the port only.
Greedy tokens must be equal everywhere: the W8A8 sharded forward has the
one-rank bits (``tests/test_torch_tp.py``), and the tiny model's top-2
margins on these prompts are far above the float engine's noise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, port_config, port_qcfg, to_numpy_tree  # noqa: F401

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
MIX = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
           num_experts_per_tok=2, max_position_embeddings=128)
PROMPTS = [[5, 9, 2, 11, 42, 7], [100, 3], [17, 17, 4, 250, 9]]
SYS = [9, 8, 7, 6, 5, 4]
MIX_REQS = [("a", SYS + [5, 9, 2, 11], 6), ("b", SYS + [100, 3], 6), ("c", [17, 17, 4], 5)]
# static engine meshes (data, model) and KV dtypes of each launch
STATIC = {2: [((1, 2), "f32"), ((2, 1), "f32")], 4: [((2, 2), "f32"), ((2, 2), "int8")]}


def _scales(n, keys, value=0.05):
    import jax.numpy as jnp

    return {k: jnp.ones((n,), jnp.float32) * value for k in keys}


def _jax_models():
    """(JAX llama module, cfg, W8A8 params, qcfg, mixtral module, cfg,
    W8A8 params): JAX ``tests/test_serve_sharded.py``'s tiny models."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.models import llama as L
    from autosmoothquant_tpu.models import mixtral as M
    from autosmoothquant_tpu.quant.config import QuantConfig

    qcfg = QuantConfig(type="int8")
    cfg = L.LlamaConfig(**TINY)
    keys = ("attn_input_scale", "q_output_scale", "k_output_scale", "v_output_scale",
            "out_input_scale", "gate_input_scale", "down_input_scale")
    lp = L.quantize(L.init_params(cfg, jax.random.PRNGKey(0)), qcfg, _scales(2, keys))
    mcfg = M.MixtralConfig(**MIX)
    ms = _scales(2, ("attn_input_scale", "q_output_scale", "k_output_scale",
                     "v_output_scale", "out_input_scale", "moe_input_scale"))
    ms["down_input_scales"] = jnp.ones((2, 4), jnp.float32) * 0.05
    mp = M.quantize(M.init_params(mcfg, jax.random.PRNGKey(0)), qcfg, ms)
    return L, cfg, lp, qcfg, M, mcfg, mp


def _mix_requests(eng, paged):
    if paged:
        eng.register_prefix("sys", SYS)
    for u, p, n in MIX_REQS:
        eng.submit(u, list(p), max_new_tokens=n,
                   **({"prefix": "sys" if p[:len(SYS)] == SYS else None} if paged else {}))
    return eng.run()


def _requests(n=3, seed=0):
    from autosmoothquant_tpu_torch.serve.batching import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, 250, size=5 + 3 * i).tolist(),
                    max_new_tokens=6) for i in range(n)]


def _port_engines(world, llama, mix, mesh_of=None, device="cpu"):
    """Every engine case of a launch of ``world`` ranks on this rank (one
    rank alone where ``world`` is 1): {case: tokens}."""
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import mixtral as TM
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu_torch.serve.multihost import MultiHostEngine, ShardedServingPool
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    cfg, q, params = llama
    mcfg, mq, mparams = mix
    f32 = dict(compute_dtype=torch.float32, device=device)
    kv = {"f32": torch.float32, "int8": torch.int8}
    out = {}
    for (data, model), kvn in STATIC.get(world, [((1, 1), "f32"), ((1, 1), "int8")]):
        eng = Engine(TL, params, cfg, q, max_batch=4, max_seq=64, kv_dtype=kv[kvn],
                     mesh=mesh_of(data=data, model=model) if mesh_of else None, **f32)
        out["static", data, model, kvn] = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=8))
    if world in (1, 2):
        mesh = mesh_of(model=2) if world == 2 else None
        from autosmoothquant_tpu_torch.serve.engine import DraftModel
        from autosmoothquant_tpu_torch.shard.sharding import llama_param_specs

        gen = GenerationConfig(max_new_tokens=8, speculative_gamma=2, speculative_ngram=2)
        for draft in (False, True):
            eng = Engine(TL, params, cfg, q, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                         mesh=mesh, draft=DraftModel(TL, params, cfg, q) if draft else None,
                         **f32)
            out["speculative", draft] = eng.generate(PROMPTS, gen)
        eng = Engine(TL, params, cfg, q, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                     mesh=mesh, param_shardings=llama_param_specs(cfg, mesh) if mesh else None,
                     fuse_projections=False, **f32)
        out["specs_unfused"] = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=8))
        for paged in (False, True):
            cls = PagedEngine if paged else ContinuousEngine
            eng = cls(TL, params, cfg, q, max_batch=2, max_seq=64, kv_dtype=torch.float32,
                      steps_per_sync=4, mesh=mesh, **({"block_size": 16} if paged else {}), **f32)
            reqs = [eng.submit(i, p, max_new_tokens=8) for i, p in enumerate(PROMPTS)]
            eng.run()
            out["continuous", paged] = {r.uid: r.output for r in reqs}
        mh = MultiHostEngine(TL, params, cfg, q, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                             mesh=mesh, **f32)
        out["multihost"] = mh.serve(_requests() if mesh is None or mesh.rank == 0 else None)
        for paged in (False, True):
            pool = ShardedServingPool(TL, params, cfg, q, max_batch=4, max_seq=64,
                                      kv_dtype=torch.float32, max_new_cap=16,
                                      engine_cls=PagedEngine if paged else None,
                                      **({"block_size": 16} if paged else {}), **f32)
            owned = [pool.submit(r.uid, r.prompt, max_new_tokens=r.max_new_tokens)
                     for r in _requests()]
            pool.run()
            out["pool", paged] = (owned, pool.gather())
    if world in (1, 4):
        mesh = mesh_of(data=1, model=2, expert=2) if world == 4 else None
        for paged in (False, True):
            cls = PagedEngine if paged else ContinuousEngine
            eng = cls(TM, mparams, mcfg, mq, max_batch=2, max_seq=64, kv_dtype=torch.float32,
                      mesh=mesh, **({"block_size": 16} if paged else {}), **f32)
            out["mixtral", paged] = _mix_requests(eng, paged)
    return out


def _rank(world, llama, mix):
    from autosmoothquant_tpu_torch.shard.mesh import make_mesh

    return _port_engines(world, llama, mix,
                         lambda **kw: make_mesh(devices=["cpu"] * world, **kw))


@pytest.fixture(scope="module")
def results():
    """{"jax": {case: tokens}, "one": the port on one rank, "ranks": {world:
    [rank results]}}: JAX's engines on each case's mesh, the port's."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.serve.batching import ContinuousEngine
    from autosmoothquant_tpu.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu.serve.paged import PagedEngine
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
    from autosmoothquant_tpu_torch.models.mixtral import MixtralConfig
    from autosmoothquant_tpu_torch.shard.mesh import launch

    L, cfg, lp, qcfg, M, mcfg, mp = _jax_models()
    llama = (port_config(cfg), port_qcfg(qcfg),
             params_from_jax(to_numpy_tree(lp), device="cpu"))
    mix = (MixtralConfig(**dataclasses.asdict(mcfg)), port_qcfg(qcfg),
           params_from_jax(to_numpy_tree(mp), device="cpu"))
    res = {"jax": {}}
    f32 = dict(compute_dtype=jnp.float32)

    def mesh(data=1, model=1, expert=None):
        n = data * model * (expert or 1)
        return make_mesh(data=data, model=model, expert=expert, devices=jax.devices()[:n])

    for world in (2, 4):
        for (data, model), kvn in STATIC[world]:
            eng = Engine(L, lp, cfg, qcfg, max_batch=4, max_seq=64, mesh=mesh(data, model),
                         kv_dtype=jnp.int8 if kvn == "int8" else jnp.float32, **f32)
            res["jax"]["static", data, model, kvn] = eng.generate(
                PROMPTS, GenerationConfig(max_new_tokens=8))
    for paged in (False, True):
        cls = PagedEngine if paged else ContinuousEngine
        eng = cls(L, lp, cfg, qcfg, max_batch=2, max_seq=64, kv_dtype=jnp.float32,
                  steps_per_sync=4, mesh=mesh(model=2), **({"block_size": 16} if paged else {}),
                  **f32)
        for i, p in enumerate(PROMPTS):
            eng.submit(i, p, max_new_tokens=8)
        res["jax"]["continuous", paged] = eng.run()
        eng = cls(M, mp, mcfg, qcfg, max_batch=2, max_seq=64, kv_dtype=jnp.float32,
                  mesh=mesh(model=2, expert=2), **({"block_size": 16} if paged else {}), **f32)
        res["jax"]["mixtral", paged] = _mix_requests(eng, paged)
    with torch.inference_mode():
        res["one"] = _port_engines(1, llama, mix)
    res["ranks"] = {world: launch(_rank, world, world, llama, mix, threads=1, timeout=600)
                    for world in (2, 4)}
    return res


def _static_cases():
    return [(w, *case) for w in (2, 4) for case in STATIC[w]]


@pytest.mark.parametrize("world,dm,kv", _static_cases(),
                         ids=[f"data{d}_model{m}_{kv}" for _, (d, m), kv in _static_cases()])
def test_engine_sharded_matches_jax_and_one_rank(results, world, dm, kv):
    """Engine.generate at (data, model), f32 or int8 KV: every rank's tokens
    are JAX's sharded engine's and the port's on one rank."""
    want = results["jax"]["static", *dm, kv]
    assert results["one"]["static", 1, 1, kv] == want
    for out in results["ranks"][world]:
        assert out["static", *dm, kv] == want


@pytest.mark.parametrize("paged", [False, True], ids=["continuous", "paged"])
def test_continuous_engines_sharded_match_jax_and_one_rank(results, paged):
    """ContinuousEngine and PagedEngine at model=2 (the pool's heads split,
    the slots whole on both ranks)."""
    want = results["jax"]["continuous", paged]
    assert results["one"]["continuous", paged] == want
    for out in results["ranks"][2]:
        assert out["continuous", paged] == want


@pytest.mark.parametrize("paged", [False, True], ids=["continuous", "paged"])
def test_mixtral_expert_tensor_sharded_engines(results, paged):
    """Mixtral's continuous and paged engines at expert=2 x model=2 (4
    ranks; the paged one sharing a registered prefix's pages): JAX's tokens
    on the same mesh, and the port's on one rank."""
    want = results["jax"]["mixtral", paged]
    assert results["one"]["mixtral", paged] == want
    for out in results["ranks"][4]:
        assert out["mixtral", paged] == want


@pytest.mark.parametrize("draft", [False, True], ids=["ngram", "draft_model"])
def test_speculative_sharded_equals_plain_greedy(results, draft):
    """Engine.generate at model=2 with speculative_gamma 2 (prompt lookup,
    or a draft model sharded as the target is): plain greedy's tokens."""
    want = results["one"]["static", 1, 1, "f32"]
    assert results["one"]["speculative", draft] == want
    for out in results["ranks"][2]:
        assert out["speculative", draft] == want


def test_explicit_specs_and_unfused_projections_serve_alike(results):
    """param_shardings (the family's specs given explicitly) with unfused
    projections gives the fused default's tokens: a rank's fused q|k|v and
    gate|up sections compute what its unfused shards do."""
    want = results["one"]["static", 1, 1, "f32"]
    for out in [results["one"]] + results["ranks"][2]:
        assert out["specs_unfused"] == want


def test_multihost_engine_matches_one_rank(results):
    """MultiHostEngine over model=2: rank 0's requests broadcast, every rank
    returns every output, equal to one rank's."""
    want = results["one"]["multihost"]
    assert set(want) == {0, 1, 2} and all(len(v) == 6 for v in want.values())
    for out in results["ranks"][2]:
        assert out["multihost"] == want


@pytest.mark.parametrize("paged", [False, True], ids=["continuous", "paged"])
def test_sharded_serving_pool_matches_one_rank(results, paged):
    """ShardedServingPool over 2 replicas: each rank owns the uids its hash
    gives it, and every rank gathers the whole result, one rank's."""
    owned0, want = results["one"]["pool", paged]
    assert all(owned0) and set(want) == {0, 1, 2}
    ranks = [out["pool", paged] for out in results["ranks"][2]]
    from autosmoothquant_tpu_torch.serve.multihost import ShardedServingPool

    for r, (owned, merged) in enumerate(ranks):
        assert owned == [ShardedServingPool._owner(u, 2) == r for u in range(3)]
        assert merged == want


# --- the marshalling, one process


def test_broadcast_requests_round_trips_as_jax():
    """One process: the fixed-shape marshalling gives JAX's requests back
    (prompt, limits, eos, sampling, stop sequences, prefix ids)."""
    from autosmoothquant_tpu.serve.batching import Request as JR
    from autosmoothquant_tpu.serve.multihost import broadcast_requests as jax_bcast
    from autosmoothquant_tpu_torch.serve.batching import Request
    from autosmoothquant_tpu_torch.serve.multihost import broadcast_requests

    spec = [dict(uid=10, prompt=[1, 2, 3], max_new_tokens=4),
            dict(uid=11, prompt=list(range(40)), max_new_tokens=9, eos_token_id=7,
                 temperature=0.5, top_k=3, top_p=0.9, repetition_penalty=1.2,
                 stop=[[1, 2], [9]], want_logprobs=True),
            dict(uid=12, prompt=[5], max_new_tokens=2, prefix="system-v1")]
    got = broadcast_requests([Request(**s) for s in spec], max_prompt=64)
    want = jax_bcast([JR(**s) for s in spec], max_prompt=64)
    fields = ("uid", "prompt", "max_new_tokens", "eos_token_id", "temperature", "top_k",
              "top_p", "repetition_penalty", "stop", "want_logprobs", "prefix")
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]


@pytest.mark.parametrize("case", ["long_prompt", "prefix_type", "stop", "count"])
def test_broadcast_requests_refuses_as_jax(case):
    from autosmoothquant_tpu.serve.batching import Request as JR
    from autosmoothquant_tpu.serve.multihost import broadcast_requests as jax_bcast
    from autosmoothquant_tpu_torch.serve.batching import Request
    from autosmoothquant_tpu_torch.serve.multihost import broadcast_requests

    kw, limits, match = {
        "long_prompt": (dict(prompt=list(range(65))), {}, "max_prompt"),
        "prefix_type": (dict(prompt=[1], prefix=123), {}, "string"),
        "stop": (dict(prompt=[1], stop=[[1]] * 5), {}, "stop sequences"),
        "count": (dict(prompt=[1]), {"max_requests": 0}, "max_requests"),
    }[case]
    for fn, cls in ((broadcast_requests, Request), (jax_bcast, JR)):
        with pytest.raises(ValueError, match=match):
            fn([cls(uid=0, max_new_tokens=2, **kw)], max_prompt=64, **limits)


def test_owner_routing_equals_jax():
    from autosmoothquant_tpu.serve.multihost import ShardedServingPool as JP
    from autosmoothquant_tpu_torch.serve.multihost import ShardedServingPool as TP

    for n in (2, 3, 4, 8):
        assert [TP._owner(u, n) for u in range(10_000)] == [JP._owner(u, n) for u in range(10_000)]


def test_pool_refuses_a_uid_past_int32():
    from autosmoothquant_tpu_torch.serve.multihost import ShardedServingPool

    pool = ShardedServingPool.__new__(ShardedServingPool)
    with pytest.raises(ValueError, match="int32"):
        pool.submit(2**31, [1, 2, 3])


def test_gloo_mesh_refuses_cuda_graphs():
    """A gloo mesh whose decode step runs collectives raises for
    cuda_graph=True rather than decode another way."""
    from autosmoothquant_tpu_torch.serve.engine import check_graph_mesh
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh

    mesh = layout_mesh(model=2)
    check_graph_mesh(False, dataclasses.replace(mesh, backend="gloo"))
    check_graph_mesh(True, layout_mesh(data=2))   # data alone: no collectives a step
    check_graph_mesh(True, dataclasses.replace(mesh, backend="nccl"))
    with pytest.raises(ValueError, match="gloo"):
        check_graph_mesh(True, dataclasses.replace(mesh, backend="gloo"))


def test_test_model_tp2_prints_what_tp1_prints(tmp_path, capsys):
    """``test_model --device cpu --tp 2`` (two gloo ranks, rank 0 prints)
    prints the new token ids ``--tp 1`` prints, on a JAX-written W8A8
    Llama artifact."""
    from autosmoothquant_tpu.convert.pipeline import save_quantized
    from autosmoothquant_tpu_torch.cli import test_model

    L, cfg, lp, qcfg, *_ = _jax_models()
    save_quantized(str(tmp_path), lp, qcfg, config_dict={
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", **dataclasses.asdict(cfg)})
    argv = ["--quantized-model-path", str(tmp_path), "--prompt-ids", "5,9,2,11,42,7",
            "--max-new-tokens", "6", "--max-seq", "64", "--device", "cpu"]
    f32 = dict(compute_dtype=torch.float32, kv_dtype=torch.float32)
    printed = []
    for tp in ("1", "2"):
        test_model.main(argv + ["--tp", tp], **f32)
        printed.append(capsys.readouterr().out.strip())
    assert len(printed[0].split()) == 6 and printed[1] == printed[0]
