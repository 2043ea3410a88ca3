"""Tensor and expert parallelism of the port's forward (``shard/``,
``models/common.py:row_linear`` / ``int4_matmul_tp``, Mixtral's expert
split) against the port on one rank and against the JAX package's forward
under the same mesh.

The port's ranks are spawned gloo processes on the CPU
(``shard/mesh.py:launch``): one launch of 2 ranks and one of 4 run every
case (their meshes are built in one order on every rank), and each test
reads its case's result. The JAX side shards the same params over the
conftest's 8 virtual devices (``shard_params`` with the family's specs) and
runs its jitted forward. Each rank imports torch and the port only; JAX is
imported inside the fixtures.

What is held:
  - against one rank: W8A8 (K1's int32 partials summed before the epilogue)
    and expert parallelism alone (a token's two experts added once) give the
    hidden state bit for bit; float, fp8 and int4 with a row-parallel
    projection sum f32 partials in another order: within ``ROW_TOL`` (atol
    and rtol 2e-5 on hidden states around 1; float on one CPU thread often
    comes out bit-equal too);
  - against JAX: the logits within each family's one-card parity tolerance
    (``tests/test_torch_{llama,opt,baichuan,gemma,mixtral}.py``);
  - ``int4_matmul_tp`` col and row against JAX's under a 4-device mesh with
    JAX's own tolerance (``tests/test_int4_tp.py``: rtol 1e-5, atol 1e-4).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_util import (jax_llama, jax_opt, one_torch_thread,  # noqa: F401
                             port_config, port_opt_config, port_qcfg, to_numpy_tree)

ROW_TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = ((2, 12), (2, 6))  # prompts: M 24 and 12 (W4A8), Mixtral sparse and dense

MIX = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
           num_experts_per_tok=2, max_position_embeddings=128, rms_norm_eps=1e-5)
BAI = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=4, model_max_length=128)
GEMMA = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=1, head_dim_override=256,
             max_position_embeddings=128, hidden_act="gelu_tanh")

# name -> (family, quant kwargs, JAX tolerance on logits, meshes (data, model,
# expert) of the 2-rank launch, of the 4-rank launch)
CASES = {
    "llama_float": ("llama", None, 1e-5, [(1, 2, None)], [(1, 4, None)]),
    "llama_w8a8": ("llama", {"type": "int8"}, 3e-2, [(1, 2, None)], [(1, 4, None)]),
    "llama_int4": ("llama", {"type": "int4", "group_size": 32}, 0.1, [(1, 2, None)],
                   [(1, 4, None)]),
    "opt_pre_ln": ("opt", {"type": "int8"}, 3e-2, [(1, 2, None)], []),
    "opt_post_ln": ("opt_post", {"type": "int8"}, 3e-2, [(1, 2, None)], []),
    "baichuan_rope": ("baichuan_rope", {"type": "int8"}, 0.1, [(1, 2, None)], []),
    "baichuan_alibi": ("baichuan_alibi", {"type": "int8"}, 0.1, [(1, 2, None)], []),
    "gemma_w8a8": ("gemma", {"type": "int8"}, 5e-2, [(1, 2, None)], []),
    "mixtral_int8": ("mixtral", {"type": "int8"}, 2e-4, [(1, 1, 2)], [(1, 2, 2)]),
    "mixtral_fp8": ("mixtral", {"type": "fp8_e4m3"}, 2e-4, [(1, 1, 2)], [(1, 2, 2)]),
    "mixtral_int4": ("mixtral", {"type": "int4", "group_size": 16}, 2e-4, [(1, 1, 2)],
                     [(1, 2, 2)]),
}
MESHES = {2: [(1, 2, None), (1, 1, 2)], 4: [(1, 4, None), (1, 2, 2)]}


def bit_equal(name, mesh) -> bool:
    """W8A8 on any mesh, and any format with the experts split alone."""
    data, model, expert = mesh
    return CASES[name][1] is not None and (CASES[name][1]["type"] == "int8" or model == 1)


def _module(family):
    import importlib

    return importlib.import_module(f"autosmoothquant_tpu_torch.models.{family}")


def _jax_case(name):
    """(JAX module, JAX cfg, JAX params, JAX qcfg, port family, port cfg)."""
    import jax
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    family, qkw = CASES[name][:2]
    if family == "llama":
        JM, cfg, params, qcfg = jax_llama(qkw, seed=3)
        return JM, cfg, params, qcfg, "llama", port_config(cfg)
    if family in ("opt", "opt_post"):
        over = {} if family == "opt" else {"do_layer_norm_before": False,
                                           "word_embed_proj_dim": 64}
        JM, cfg, params, qcfg = jax_opt(qkw, seed=3, **over)
        return JM, cfg, params, qcfg, "opt", port_opt_config(cfg)
    from autosmoothquant_tpu.calibrate.calibrate import calibrate as jcal

    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, size=(2, 32)).astype(np.int32) for _ in range(2)]
    if family.startswith("baichuan"):
        from autosmoothquant_tpu.models import baichuan as JM
        from autosmoothquant_tpu_torch.models import baichuan as TM

        pe = family.split("_")[1].upper()
        cfg = JM.BaichuanConfig(**BAI, force_position_embedding=pe)
        tcfg = TM.BaichuanConfig(**BAI, force_position_embedding=pe)
        kw, port_family = {}, "baichuan"
    elif family == "gemma":
        from autosmoothquant_tpu.models import gemma as JM
        from autosmoothquant_tpu_torch.models import gemma as TM

        cfg, tcfg = JM.LlamaConfig(**GEMMA), TM.LlamaConfig(**GEMMA)
        kw, port_family = {}, "gemma"
    else:
        from autosmoothquant_tpu.models import mixtral as JM
        from autosmoothquant_tpu_torch.models import mixtral as TM

        cfg, tcfg = JM.MixtralConfig(**MIX), TM.MixtralConfig(**MIX)
        kw, port_family = {"extra_forward_kwargs": JM.CALIBRATION_FORWARD_KWARGS}, "mixtral"
    params, stats = _calibrated(family, JM, cfg, jcal, batches, kw)
    qcfg = JQ(**qkw)
    src = JM.smooth(params, stats, 0.5, cfg=cfg) if qcfg.is_int8 else params
    params = JM.quantize(src, qcfg, JM.layer_scales(stats), cfg=cfg)
    return JM, cfg, params, qcfg, port_family, tcfg


_STATS = {}


def _calibrated(family, JM, cfg, jcal, batches, kw):
    """(float params, their calibration statistics), once a family config
    (Mixtral's three formats share them)."""
    import jax

    if family not in _STATS:
        params = JM.init_params(cfg, jax.random.PRNGKey(5))
        _STATS[family] = (params, jcal(JM, params, cfg, iter(batches), **kw))
    return _STATS[family]


def jax_shapes(name) -> int:
    """The prompt shapes JAX's sharded forward runs: both for Mixtral (the
    sparse and the dense route), the first elsewhere (one compile a mesh;
    the port's ranks run both against one rank)."""
    return len(SHAPES) if name.startswith("mixtral") else 1


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int64)


def _rank_forwards(cases, world, int4_tp):
    """One rank of ``world``: every case on each of its meshes (built in one
    order on every rank): the hidden state and logits of each prompt shape;
    with 4 ranks also ``int4_matmul_tp`` col and row on ``int4_tp``."""
    from autosmoothquant_tpu_torch.models.common import int4_matmul_tp
    from autosmoothquant_tpu_torch.shard.mesh import make_mesh
    from autosmoothquant_tpu_torch.shard.sharding import param_specs, shard_params, tp_plan

    meshes = {sizes: make_mesh(*sizes, devices=["cpu"] * world) for sizes in MESHES[world]}
    out = {}
    with torch.inference_mode():
        for name, family, tcfg, tq, params, ids in cases:
            mod = _module(family)
            for sizes in CASES[name][4 if world == 4 else 3]:
                mesh = meshes[sizes]
                plan = tp_plan(mod.FAMILY, tcfg, mesh, tq)
                sp = shard_params(params, mesh, param_specs(mod.FAMILY, tcfg, mesh), plan)
                fused = (mod.fuse_decode_projections(sp)
                         if hasattr(mod, "fuse_decode_projections") else None)
                for j, x in enumerate(ids):
                    h, _ = mod.forward(sp, torch.from_numpy(x), tcfg, tq, mesh=mesh,
                                       compute_dtype=torch.float32)
                    out[name, sizes, j] = (h, mod.logits(sp, h, mesh))
                    if fused is not None:
                        out[name, sizes, j, "fused"] = mod.forward(
                            fused, torch.from_numpy(x), tcfg, tq, mesh=mesh,
                            compute_dtype=torch.float32)[0]
        if world == 4:
            mesh = meshes[(1, 4, None)]
            x, p, bias = int4_tp
            i = mesh.axis("model").index
            for tp in ("col", "row"):
                if tp == "col":
                    n = p["w"].shape[0] // 4
                    pl = {"w": p["w"][i * n:(i + 1) * n],
                          "w_scales": p["w_scales"][i * n:(i + 1) * n]}
                    got = int4_matmul_tp(x, pl, bias=bias[i * n:(i + 1) * n],
                                         out_dtype=torch.float32, tp="col", mesh=mesh)
                    got = mesh.axis("model").all_gather(got, dim=-1)
                else:
                    kh = p["w"].shape[1] // 4
                    k = x.shape[1] // 4
                    pl = {"w": p["w"][:, i * kh:(i + 1) * kh], "w_scales": p["w_scales"]}
                    got = int4_matmul_tp(x[:, i * k:(i + 1) * k], pl, bias=bias,
                                         out_dtype=torch.float32, tp="row", mesh=mesh)
                out["int4_tp", tp] = got
    return out


def _int4_tp_operands():
    """JAX ``tests/test_int4_tp.py``'s operands: a 2-layer stacked packed
    weight (K 256, N 512, group 32), x [8, 256], a bias; layer 1."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.quant.math import quantize_weight_int4_grouped

    w = jax.random.normal(jax.random.PRNGKey(0), (2, 256, 512), jnp.float32) * 0.1
    packs, scs = zip(*(quantize_weight_int4_grouped(w[l], 32) for l in range(2)))
    packed, scales = jnp.stack(packs), jnp.stack(scs)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 256), jnp.float32) * 2.0
    bias = jnp.arange(512, dtype=jnp.float32) * 1e-3
    return x, packed, scales, bias


@pytest.fixture(scope="module")
def results():
    """Every case through JAX (sharded), the port on one rank and the port's
    ranks: {"jax": {(name, sizes, j): logits}, "one": {(name, j): (hidden,
    logits)}, "ranks": {world: [rank results]}, "int4_tp": {...}}."""
    import jax
    from autosmoothquant_tpu.models.common import int4_matmul_tp as jax_int4_tp
    from autosmoothquant_tpu.shard import make_mesh as jax_mesh
    from autosmoothquant_tpu.shard import param_specs as jax_specs
    from autosmoothquant_tpu.shard import shard_params as jax_shard
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
    from autosmoothquant_tpu_torch.shard.mesh import launch

    env = os.environ.get("ASQ_FUSED_BLOCK")
    os.environ["ASQ_FUSED_BLOCK"] = "force"  # the fused route the port takes
    jax.clear_caches()
    res = {"jax": {}, "one": {}}
    cases = []
    try:
        for name in CASES:
            JM, cfg, jp, jq, family, tcfg = _jax_case(name)
            tq = port_qcfg(jq)
            tp = params_from_jax(to_numpy_tree(jp), tcfg, device="cpu")
            ids = [_ids(s, 7 + j) for j, s in enumerate(SHAPES)]
            mod = _module(family)
            for j, x in enumerate(ids):
                with torch.inference_mode():
                    h, _ = mod.forward(tp, torch.from_numpy(x), tcfg, tq,
                                       compute_dtype=torch.float32)
                    res["one"][name, j] = (h.numpy(), mod.logits(tp, h).numpy())
            jfam = JM.FAMILY if hasattr(JM, "FAMILY") else family
            for sizes in CASES[name][3] + CASES[name][4]:
                data, model, expert = sizes
                n = data * model * (expert or 1)
                mesh = jax_mesh(data=data, model=model, expert=expert,
                                devices=jax.devices()[:n])
                sharded = jax_shard(jp, mesh, jax_specs(jfam, cfg, mesh))
                for j, x in enumerate(ids[:jax_shapes(name)]):
                    h = JM.forward_jit(sharded, jax.numpy.asarray(x, jax.numpy.int32), cfg, jq)[0]
                    res["jax"][name, sizes, j] = np.asarray(JM.logits(sharded, h))
            cases.append((name, family, tcfg, tq, tp, ids))
        x, packed, scales, bias = _int4_tp_operands()
        p = {"w": packed, "w_scales": scales, "layer": 1}
        mesh = jax_mesh(data=1, model=4, devices=jax.devices()[:4])
        with jax.sharding.set_mesh(mesh):
            res["int4_tp"] = {tp: np.asarray(jax.jit(lambda x_, tp=tp: jax_int4_tp(
                x_, p, bias=bias, out_dtype=jax.numpy.float32, tp=tp))(x)) for tp in ("col", "row")}
        res["int4_tp_operands"] = int4_tp = (torch.from_numpy(np.array(x)),
                   {"w": torch.from_numpy(np.array(packed[1])).t().contiguous(),
                    "w_scales": torch.from_numpy(np.array(scales[1])).t().contiguous()},
                   torch.from_numpy(np.array(bias)))
    finally:
        if env is None:
            os.environ.pop("ASQ_FUSED_BLOCK", None)
        else:
            os.environ["ASQ_FUSED_BLOCK"] = env
    res["ranks"] = {world: launch(_rank_forwards, world, cases, world, int4_tp,
                                  threads=1, timeout=600)
                    for world in (2, 4)}
    return res


def _ranked(name):
    return ([(2, s) for s in CASES[name][3]] + [(4, s) for s in CASES[name][4]])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_matches_one_rank(results, name):
    """Every rank's hidden state and gathered logits against the port on one
    rank: bit-equal where ``bit_equal`` says so, else within ROW_TOL."""
    for world, sizes in _ranked(name):
        for j in range(len(SHAPES)):
            h1, lg1 = results["one"][name, j]
            for r, out in enumerate(results["ranks"][world]):
                h, lg = out[name, sizes, j]
                if bit_equal(name, sizes):
                    assert np.array_equal(h, h1), (name, sizes, j, r)
                else:
                    np.testing.assert_allclose(h, h1, **ROW_TOL, err_msg=f"{sizes} {r}")
                np.testing.assert_allclose(lg, lg1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] in ("llama", "gemma")])
def test_rank_fused_sections_equal_its_unfused_shards(results, name):
    """A rank fuses its own q|k|v and gate|up sections (the engines do):
    K1's columns do not depend on their neighbours, so the W8A8 hidden state
    is the unfused shards' bit for bit (float and int4 within ROW_TOL)."""
    for world, sizes in _ranked(name):
        for j in range(len(SHAPES)):
            for out in results["ranks"][world]:
                got, want = out[name, sizes, j, "fused"], out[name, sizes, j][0]
                if CASES[name][1] is not None and CASES[name][1]["type"] == "int8":
                    assert np.array_equal(got, want), (name, sizes, j)
                else:
                    np.testing.assert_allclose(got, want, **ROW_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_matches_jax(results, name):
    """Rank 0's logits against JAX's forward on the same mesh, within the
    family's one-card parity tolerance."""
    tol = CASES[name][2]
    for world, sizes in _ranked(name):
        for j in range(jax_shapes(name)):
            got = results["ranks"][world][0][name, sizes, j][1]
            np.testing.assert_allclose(got, results["jax"][name, sizes, j], atol=tol,
                                       rtol=tol if name.startswith("mixtral") else 0)


@pytest.mark.parametrize("tp", ["col", "row"])
def test_int4_matmul_tp_matches_jax(results, tp):
    """int4_matmul_tp over 4 ranks against JAX's under a 4-device mesh
    (col: output columns gathered from the ranks; row: the ranks' sum), and
    against the port's one-rank product."""
    from autosmoothquant_tpu_torch.kernels.int4 import int4_matmul

    want = results["int4_tp"][tp]
    x, p, bias = results["int4_tp_operands"]
    one = int4_matmul(x, p["w"], p["w_scales"], bias, out_dtype=torch.float32).numpy()
    for out in results["ranks"][4]:
        np.testing.assert_allclose(out["int4_tp", tp], want, rtol=1e-5, atol=1e-4)
        if tp == "col":
            assert np.array_equal(out["int4_tp", tp], one)
        else:
            np.testing.assert_allclose(out["int4_tp", tp], one, rtol=1e-5, atol=1e-4)


# --- the kernels' new modes, plain versions (their card twins: test_torch_gpu.py)


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (9, 70, 130), (33, 256, 96)])
def test_int8_int32_output_and_epilogue_give_the_kernel_bits(m, k, n):
    """K1's int32 output is the exact accumulator; its epilogue in torch ops
    gives int8_matmul's f32 and bf16 bits on the same inputs, with per-token
    row scales, per-column scales and a bias."""
    from autosmoothquant_tpu_torch.kernels import gemm as G

    g = torch.Generator().manual_seed(m + k)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    acc = G.int8_matmul(x, w, out_dtype=torch.int32)
    assert torch.equal(acc, x.to(torch.int64).matmul(w.to(torch.int64).t()).to(torch.int32))
    rs, cs = torch.rand(m, generator=g) + 0.5, torch.rand(n, generator=g) / 500
    bias = torch.randn(n, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(G.epilogue(acc, rs, cs, bias, out_dtype=dt),
                           G.int8_matmul(x, w, rs, cs, bias, out_dtype=dt))
    with pytest.raises(ValueError, match="accumulator"):
        G.int8_matmul(x, w, col_scale=cs, out_dtype=torch.int32)


def test_int4_plain_takes_a_given_scale_and_route():
    """K5's plain version with the row's own scale given is the plain
    version; a larger given scale quantizes against it (x_q through an
    identity weight); ``a8=False`` takes W4A16 and M > 64 with a8 raises."""
    from autosmoothquant_tpu_torch.kernels import int4 as I4
    from autosmoothquant_tpu_torch.quant import math as Q

    g = torch.Generator().manual_seed(3)
    w = torch.randn(256, 96, generator=g)
    packed, scales = (t.t().contiguous() for t in Q.quantize_weight_int4_grouped(w, 32))
    x = torch.randn(5, 256, generator=g) * 3
    _, own = Q.quantize_act_per_token(x)
    base = I4.int4_matmul(x, packed, scales, out_dtype=torch.float32)
    assert torch.equal(I4.int4_matmul(x, packed, scales, out_dtype=torch.float32,
                                      tok_scale=own[:, 0]), base)
    big = own[:, 0] * 2
    q = Q.quantize_act_static(x, big[:, None])
    ref = I4.int4_matmul_plain(x, packed, scales, out_dtype=torch.float32, tok_scale=big)
    wq = torch.cat(Q.unpack_int4(packed), dim=1).float()
    srep = scales.repeat_interleave(32, dim=1)
    torch.testing.assert_close(ref, (q.float() @ (wq * srep).t()) * big[:, None],
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(I4.int4_matmul(x, packed, scales, a8=False),
                               I4.int4_matmul_w4a16(x, packed, scales))
    with pytest.raises(ValueError, match="W4A8"):
        I4.int4_matmul(torch.zeros(65, 256), packed, scales, a8=True)


# --- the plan, a pure function of the sizes


@pytest.mark.parametrize("n_q,n_kv,m,want", [
    (4, 2, 2, [None, None]),            # kv heads split whole
    (4, 2, 4, [(0,), (0,), (1,), (1,)]),  # few-KV GQA: each rank reads one
    (8, 2, 4, [(0,), (0,), (1,), (1,)]),
    (12, 3, 2, [(0, 0, 0, 0, 1, 1), (1, 1, 2, 2, 2, 2)]),  # uneven groups: a head each
    (2, 1, 2, [(0,), (0,)]),            # Gemma-2B's single kv head
])
def test_plan_reads_the_kv_heads_its_query_heads_map_to(n_q, n_kv, m, want):
    from autosmoothquant_tpu_torch.models.llama import LlamaConfig
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.sharding import tp_plan

    cfg = LlamaConfig(vocab_size=64, hidden_size=n_q * 16, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=n_q, num_key_value_heads=n_kv)
    for r in range(m):
        plan = tp_plan("llama", cfg, layout_mesh(model=m, rank=r))
        assert plan.attn and plan.q_heads == n_q // m and plan.q_offset == r * n_q // m
        assert plan.kv_index == want[r]
        g = n_q // n_kv
        heads = range(plan.q_offset, plan.q_offset + plan.q_heads)
        idx = plan.kv_index or tuple(range(r * n_kv // m, (r + 1) * n_kv // m))
        per = plan.q_heads // len(idx)
        assert [idx[j // per] for j in range(plan.q_heads)] == [h // g for h in heads]
