"""The port's stage axis (``shard/pipeline.py``, ``shard/sharding.py:
with_stage_axis``, the engines' stage placement, perplexity over stages)
against the JAX package's (``tests/test_pipeline.py``,
``tests/test_serve_sharded.py:123-150``) and against the port on one rank.

The port's ranks are spawned gloo processes on the CPU
(``shard/mesh.py:launch``): one launch of 8 ranks runs every pipeline case
(each on JAX's mesh of that case: stage x data x model over 8 devices) and
the static engine at stage 2 x model 4, one launch of 2 ranks the engines
at stage 2 alone. JAX runs each case's ``pipelined_forward`` and engines on
the conftest's 8 virtual devices. Each rank imports torch and the port only.

What is held (hidden states are around 1; readings on an 8-core AVX-512
host in brackets):
  - W8A8 (the calibrated Llama at stage 2 x data 2 x model 2): the port's
    pipelined hidden state is its one-rank forward's bit for bit, and within
    ``W8A8_TOL`` (atol 2e-5) of JAX's pipelined one [4.8e-7; an int8
    rounding that flipped between the packages' float attention would show
    as about 1e-2];
  - float arms: within ``FLOAT_TOL`` of the port's one-rank forward (rtol
    and atol 2e-5, ``tests/test_torch_tp.py``'s ROW_TOL: row-parallel
    projections sum f32 partials in another order) [3.1e-6] and of JAX's
    pipelined forward (JAX's own 1e-4 against its plain scan) [3.8e-6];
  - perplexity: pipelined over 4 stages x model 2, within a relative 2e-6 of
    JAX's serial and pipelined values [9.5e-8] and 1e-6 of the port's
    serial one [9.5e-8];
  - engines: greedy tokens equal to JAX's engine on the same stage mesh and
    to the port's on one rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_util import one_torch_thread, port_config, port_opt_config, port_qcfg  # noqa: F401
from test_torch_util import to_numpy_tree

FLOAT_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_FLOAT_TOL = 1e-4
W8A8_TOL = 2e-5
PPL_RTOL = 2e-6

LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=64)
OPT = dict(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=4,
           num_attention_heads=8, word_embed_proj_dim=64, max_position_embeddings=64)
BAICHUAN = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=8, model_max_length=64, force_position_embedding="ALIBI")
MIXTRAL = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
               num_attention_heads=8, num_key_value_heads=4, num_local_experts=4,
               max_position_embeddings=64)
# JAX tests/test_pipeline.py's cases: name -> (model, (stage, data, model),
# microbatches, batch, length)
CASES = {
    "llama_fp": ("llama", (4, 1, 2), 4, 8, 12),
    "llama_int8": ("llama_int8", (2, 2, 2), 4, 8, 12),
    "llama_more_microbatches": ("llama", (2, 1, 4), 8, 8, 12),
    "opt": ("opt", (4, 1, 2), 4, 8, 12),
    "baichuan_alibi": ("baichuan", (2, 1, 4), 4, 8, 12),
    "mixtral": ("mixtral", (4, 1, 2), 4, 8, 12),
}
PPL_MESH = (4, 1, 2)
ENGINE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128)
PROMPTS = [[5, 9, 2, 11, 42, 7], [100, 3], [17, 17, 4, 250, 9]]


def _ids(b, t, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t)).astype(np.int64)


def _stream():
    return np.random.default_rng(7).integers(0, 256, size=64 * 5).astype(np.int64)


def _jax_models():
    """name -> (JAX module, JAX cfg, JAX params, JAX qcfg, port module, port
    cfg): JAX tests/test_pipeline.py's models, and its engine model."""
    import jax
    from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize
    from autosmoothquant_tpu.models import baichuan as JB
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.models import mixtral as JM
    from autosmoothquant_tpu.models import opt as JO
    from autosmoothquant_tpu.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.models import baichuan as TB
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import mixtral as TM
    from autosmoothquant_tpu_torch.models import opt as TO

    out = {}
    cfg = JL.LlamaConfig(**LLAMA)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    out["llama"] = (JL, cfg, params, None, TL, port_config(cfg))
    rng = np.random.default_rng(0)
    calib = [rng.integers(0, 256, size=(2, 16)).astype(np.int32) for _ in range(2)]
    qcfg = QuantConfig(type="int8")
    qparams, _ = calibrate_smooth_quantize(JL, params, cfg, qcfg, lambda: iter(calib))
    out["llama_int8"] = (JL, cfg, qparams, qcfg, TL, port_config(cfg))
    cfg = JO.OPTConfig(**OPT)
    out["opt"] = (JO, cfg, JO.init_params(cfg, jax.random.PRNGKey(1)), None, TO,
                  port_opt_config(cfg))
    cfg = JB.BaichuanConfig(**BAICHUAN)
    out["baichuan"] = (JB, cfg, JB.init_params(cfg, jax.random.PRNGKey(2)), None, TB,
                       TB.BaichuanConfig(**BAICHUAN))
    cfg = JM.MixtralConfig(**MIXTRAL)
    out["mixtral"] = (JM, cfg, JM.init_params(cfg, jax.random.PRNGKey(3)), None, TM,
                      TM.MixtralConfig(**MIXTRAL))
    cfg = JL.LlamaConfig(**ENGINE)
    keys = ("attn_input_scale", "q_output_scale", "k_output_scale", "v_output_scale",
            "out_input_scale", "gate_input_scale", "down_input_scale")
    scales = {k: jax.numpy.ones((2,), jax.numpy.float32) * 0.05 for k in keys}
    out["engine"] = (JL, cfg, JL.quantize(JL.init_params(cfg, jax.random.PRNGKey(0)), qcfg,
                                          scales), qcfg, TL, port_config(cfg))
    return out


def _port(models):
    """name -> (port module name, port cfg, port qcfg, port params)."""
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax

    return {name: (tm.__name__, tcfg, port_qcfg(jq),
                   params_from_jax(to_numpy_tree(jp), tcfg, device="cpu"))
            for name, (_, _, jp, jq, tm, tcfg) in models.items()}


def _stage_mesh(stage, data, model, world):
    from autosmoothquant_tpu_torch.shard.mesh import make_mesh

    return make_mesh(data=data, model=model, stage=stage, devices=["cpu"] * world)


def _shard(mod, cfg, qcfg, params, mesh):
    from autosmoothquant_tpu_torch.shard.sharding import (param_specs, shard_params, tp_plan,
                                                          with_stage_axis)

    specs = with_stage_axis(param_specs(mod.FAMILY, cfg, mesh), mesh, cfg.num_hidden_layers)
    return shard_params(params, mesh, specs, tp_plan(mod.FAMILY, cfg, mesh, qcfg))


def _engines(port, mesh=None, static_only=False):
    """Greedy tokens of the engine model's static engine, and unless
    ``static_only`` its continuous and paged engines, under ``mesh``."""
    import importlib

    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    name, cfg, q, params = port["engine"]
    mod = importlib.import_module(name)
    f32 = dict(compute_dtype=torch.float32, kv_dtype=torch.float32, device="cpu", mesh=mesh)
    eng = Engine(mod, params, cfg, q, max_batch=4, max_seq=64, **f32)
    out = {"static": eng.generate(PROMPTS, GenerationConfig(max_new_tokens=8)),
           "static_layers": (len(eng.params["layers"]), len(eng.kv_cache))}
    if static_only:
        return out
    for paged in (False, True):
        cls = PagedEngine if paged else ContinuousEngine
        eng = cls(mod, params, cfg, q, max_batch=2, max_seq=64, steps_per_sync=4,
                  **({"block_size": 16} if paged else {}), **f32)
        reqs = [eng.submit(i, p, max_new_tokens=8) for i, p in enumerate(PROMPTS)]
        eng.run()
        out["continuous", paged] = {r.uid: r.output for r in reqs}
    return out


def _rank8(port):
    """One of 8 ranks: every pipeline case on its mesh, pipelined perplexity
    at stage 4 x model 2, and the static engine at stage 2 x model 4."""
    import importlib

    from autosmoothquant_tpu_torch.eval.ppl import perplexity_from_tokens
    from autosmoothquant_tpu_torch.shard.pipeline import pipelined_forward

    out = {}
    with torch.inference_mode():
        for case, (model, sizes, mbs, b, t) in CASES.items():
            name, cfg, q, params = port[model]
            mod = importlib.import_module(name)
            mesh = _stage_mesh(*sizes, 8)
            sp = _shard(mod, cfg, q, params, mesh)
            h = pipelined_forward(mod, sp, torch.from_numpy(_ids(b, t)), cfg, q, mesh=mesh,
                                  microbatches=mbs)
            out[case] = (h, len(sp["layers"]), sorted(k for k in sp if k != "layers"))
        name, cfg, q, params = port["llama"]
        mod = importlib.import_module(name)
        mesh = _stage_mesh(*PPL_MESH, 8)
        out["ppl"] = perplexity_from_tokens(mod, _shard(mod, cfg, q, params, mesh), cfg,
                                            _stream(), max_length=64, mesh=mesh,
                                            microbatches=2, batch_windows=4, device="cpu")
        out["engine"] = _engines(port, _stage_mesh(2, 1, 4, 8), static_only=True)
    return out


def _rank2(port):
    with torch.inference_mode():
        return _engines(port, _stage_mesh(2, 1, 1, 2))


@pytest.fixture(scope="module")
def results():
    """{"jax": {case: hidden or tokens}, "one": the port on one rank,
    "ranks": {world: [rank results]}}."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.eval.ppl import perplexity_from_tokens as jppl
    from autosmoothquant_tpu.serve.batching import ContinuousEngine
    from autosmoothquant_tpu.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu.serve.paged import PagedEngine
    from autosmoothquant_tpu.shard import make_mesh, param_specs, shard_params
    from autosmoothquant_tpu.shard.pipeline import pipelined_forward
    from autosmoothquant_tpu.shard.sharding import with_stage_axis
    from autosmoothquant_tpu_torch.eval.ppl import perplexity_from_tokens
    from autosmoothquant_tpu_torch.shard.mesh import launch
    from autosmoothquant_tpu_torch.shard.pipeline import pipelined_forward as tpiped

    models = _jax_models()
    port = _port(models)
    res = {"jax": {}, "one": {}}

    def jmesh(stage, data, model):
        n = stage * data * model
        return make_mesh(stage=stage, data=data, model=model, devices=jax.devices()[:n])

    def jshard(jm, cfg, params, mesh):
        specs = with_stage_axis(param_specs(jm.FAMILY, cfg, mesh), mesh, cfg.num_hidden_layers)
        return shard_params(params, mesh, specs)

    for case, (model, sizes, mbs, b, t) in CASES.items():
        jm, cfg, params, qcfg, tm, tcfg = models[model]
        mesh = jmesh(*sizes)
        res["jax"][case] = np.asarray(pipelined_forward(
            jm, jshard(jm, cfg, params, mesh), jnp.asarray(_ids(b, t)), cfg, qcfg, mesh=mesh,
            microbatches=mbs))
        with torch.inference_mode():
            res["one"][case] = tm.forward(port[model][3], torch.from_numpy(_ids(b, t)), tcfg,
                                          port[model][2])[0].numpy()
    jm, cfg, params, _, tm, tcfg = models["llama"]
    ids = _ids(4, 8, seed=5)
    res["jax"]["no_mesh"] = np.asarray(jm.forward_jit(params, jnp.asarray(ids), cfg)[0])
    with torch.inference_mode():
        res["one"]["no_mesh"] = tm.forward(port["llama"][3], torch.from_numpy(ids), tcfg)[0]
        res["one"]["no_mesh_piped"] = tpiped(tm, port["llama"][3], torch.from_numpy(ids), tcfg,
                                             microbatches=2)
    mesh = jmesh(*PPL_MESH)
    res["jax"]["ppl_serial"] = jppl(jm, params, cfg, _stream(), max_length=64)
    res["jax"]["ppl"] = jppl(jm, jshard(jm, cfg, params, mesh), cfg, _stream(), max_length=64,
                             mesh=mesh, microbatches=2, batch_windows=4)
    res["one"]["ppl_serial"] = perplexity_from_tokens(tm, port["llama"][3], tcfg, _stream(),
                                                      max_length=64, device="cpu")
    res["one"]["ppl_batched"] = perplexity_from_tokens(tm, port["llama"][3], tcfg, _stream(),
                                                       max_length=64, batch_windows=2,
                                                       device="cpu")
    jm, cfg, params, qcfg, _, _ = models["engine"]
    f32 = dict(compute_dtype=jnp.float32, kv_dtype=jnp.float32)
    for sizes in ((2, 1, 4), (2, 1, 1)):
        eng = Engine(jm, params, cfg, qcfg, max_batch=4, max_seq=64, mesh=jmesh(*sizes), **f32)
        res["jax"]["static", sizes] = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=8))
    for paged in (False, True):
        cls = PagedEngine if paged else ContinuousEngine
        eng = cls(jm, params, cfg, qcfg, max_batch=2, max_seq=64, steps_per_sync=4,
                  mesh=jmesh(2, 1, 1), **({"block_size": 16} if paged else {}), **f32)
        for i, p in enumerate(PROMPTS):
            eng.submit(i, p, max_new_tokens=8)
        res["jax"]["continuous", paged] = eng.run()
    with torch.inference_mode():
        res["one"]["engine"] = _engines(port)
    res["ranks"] = {8: launch(_rank8, 8, port, threads=1, timeout=600),
                    2: launch(_rank2, 2, port, threads=1, timeout=600)}
    return res


def _last_stage(ranks, case):
    """The case's hidden states from its last stage's ranks (the others
    return None)."""
    got = [r[case][0] for r in ranks if r[case][0] is not None]
    stage, data, model = CASES[case][1]
    assert len(got) == data * model
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_forward_matches_jax_and_one_rank(results, case):
    """JAX tests/test_pipeline.py's cases (llama float and int8, more
    microbatches than stages, OPT, Baichuan with ALiBi, Mixtral), each on
    its mesh: every last-stage rank's hidden state against JAX's pipelined
    one and the port's one-rank forward; W8A8 bit for bit."""
    want_jax, one = results["jax"][case], results["one"][case]
    for h in _last_stage(results["ranks"][8], case):
        if case == "llama_int8":
            np.testing.assert_array_equal(h, one)
            np.testing.assert_allclose(h, want_jax, atol=W8A8_TOL, rtol=0)
        else:
            np.testing.assert_allclose(h, one, **FLOAT_TOL)
            np.testing.assert_allclose(h, want_jax, atol=JAX_FLOAT_TOL, rtol=JAX_FLOAT_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_a_rank_holds_its_stage_only(results, case):
    """A rank holds L / S layers; the embedding lives on the first stage,
    the head on the last, a middle stage keeps neither."""
    stage, data, model = CASES[case][1]
    name = CASES[case][0].split("_")[0]
    layers = {"llama": LLAMA, "opt": OPT, "baichuan": BAICHUAN,
              "mixtral": MIXTRAL}[name]["num_hidden_layers"]
    ranks = results["ranks"][8]
    every = set().union(*(out[case][2] for out in ranks))
    first = every & {"embed", "embed_pos", "project_in"}
    head = every & {"final_norm", "lm_head", "project_out"}
    assert "embed" in first and "lm_head" in head
    for rank, out in enumerate(ranks):
        s = np.unravel_index(rank, (stage, data, model))[0]
        keys = set(out[case][2])
        assert out[case][1] == layers // stage
        assert keys & first == (first if s == 0 else set())
        assert keys & head == (head if s == stage - 1 else set())


def test_pipelined_forward_without_a_mesh_equals_forward(results):
    """No mesh: the schedule runs on one rank, two microbatches, and equals
    the family's forward (JAX's 1e-5 against its plain scan)."""
    got = results["one"]["no_mesh_piped"].numpy()
    np.testing.assert_allclose(got, results["one"]["no_mesh"].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, results["jax"]["no_mesh"], rtol=1e-5, atol=1e-5)


def test_ppl_batched_and_pipelined_match_serial(results):
    """Batched and stage-pipelined perplexity (4 stages x model 2, 2
    microbatches of 4 windows, a clamped tail) equal the serial value; every
    rank returns the same float."""
    ref = results["one"]["ppl_serial"]
    assert abs(ref - results["jax"]["ppl_serial"]) / ref < PPL_RTOL
    assert abs(results["one"]["ppl_batched"] - ref) / ref < 1e-6
    got = [r["ppl"] for r in results["ranks"][8]]
    assert len(set(got)) == 1
    assert abs(got[0] - ref) / ref < 1e-6
    assert abs(got[0] - results["jax"]["ppl"]) / ref < PPL_RTOL


@pytest.mark.parametrize("sizes", [(2, 1, 4), (2, 1, 1)], ids=["stage2_model4", "stage2"])
def test_engine_stage_sharded_matches_jax_and_one_rank(results, sizes):
    """Engine.generate with the layers placed over 2 stages (JAX
    test_engine_stage_sharded_matches_single / test_stage_only_mesh): JAX's
    tokens on the same mesh, the port's on one rank, on every rank; a rank
    holds its stage's layers and their cache."""
    want = results["jax"]["static", sizes]
    assert results["one"]["engine"]["static"] == want
    ranks = results["ranks"][8] if sizes[2] == 4 else results["ranks"][2]
    for out in ranks:
        eng = out["engine"] if sizes[2] == 4 else out
        assert eng["static"] == want
        assert eng["static_layers"] == (1, 1)


@pytest.mark.parametrize("paged", [False, True], ids=["continuous", "paged"])
def test_continuous_engines_stage_sharded(results, paged):
    """ContinuousEngine and PagedEngine over 2 stages: JAX's tokens on the
    same mesh and the port's on one rank, on both ranks."""
    want = results["jax"]["continuous", paged]
    assert results["one"]["engine"]["continuous", paged] == want
    for out in results["ranks"][2]:
        assert out["continuous", paged] == want


def test_with_stage_axis_and_stage_stack_refuse_as_jax():
    """Layers that do not divide over the stages raise; "stage" leads every
    layer spec and nothing else; a stage mesh refuses specs without it."""
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.pipeline import stage_stack
    from autosmoothquant_tpu_torch.shard.sharding import (llama_param_specs, shard_params,
                                                          tp_plan, with_stage_axis)

    cfg = TL.LlamaConfig(**LLAMA)
    mesh = layout_mesh(model=2, stage=2)
    specs = with_stage_axis(llama_param_specs(cfg, mesh), mesh, 4)
    assert specs["layers"]["attn"]["q"]["w"] == ("stage", None, "model")
    assert specs["lm_head"] == llama_param_specs(cfg, mesh)["lm_head"]
    assert with_stage_axis(specs, layout_mesh(model=2), 3) == specs
    with pytest.raises(ValueError, match="not divisible"):
        with_stage_axis(llama_param_specs(cfg, mesh), mesh, 3)
    with pytest.raises(ValueError, match="not divisible"):
        stage_stack(list(range(6)), 4)
    assert stage_stack(list(range(6)), 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="with_stage_axis"):
        shard_params({"layers": [{}] * 4}, mesh, llama_param_specs(cfg, mesh),
                     tp_plan("llama", cfg, mesh))


def _stage_fails(world):
    """Stage 1 raises before its send; stage 0 waits on the hidden state it
    would have sent."""
    from autosmoothquant_tpu_torch.shard.mesh import make_mesh

    mesh = make_mesh(stage=world, devices=["cpu"] * world)
    st = mesh.axis("stage")
    if st.index == 1:
        raise RuntimeError("stage 1 fails")
    return st.recv((2, 4), torch.float32, "cpu", 1)


def test_a_failing_stage_fails_the_launch_at_once():
    """A stage that raises makes ``launch`` raise with its traceback while its
    neighbour still waits on a receive, long before the timeout."""
    import time

    from autosmoothquant_tpu_torch.shard.mesh import launch

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*stage 1 fails"):
        launch(_stage_fails, 2, 2, threads=1, timeout=120)
    assert time.monotonic() - t0 < 60
