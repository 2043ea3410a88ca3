"""The port's mesh and sharding rules (``shard/mesh.py``,
``shard/sharding.py``) against the JAX package's, with no processes: a
rank's mesh is a pure function of the sizes (``layout_mesh``), and so are
the specs and a rank's shard of the params.

  - the rank layout: rank r sits where JAX's ``make_mesh`` puts device r;
  - the specs: JAX's, leaf by leaf, for every family and axis combination;
  - the shards: what JAX's device r holds, in the port's layout ([N, K]
    quantized weights, [N, G] int4 scales: JAX's last two dimensions
    swapped), with the port's stated exceptions: Baichuan's W_pack split
    section by section (JAX splits the fused dimension contiguously, then
    reshards), k/v kept whole where the kv heads do not split whole, and
    int4 experts held whole over "model" (JAX's ``_storage_spec`` too).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_util import jax_llama, jax_opt, port_config, port_opt_config, to_numpy_tree

# (data, model, expert) over 8 devices, and over fewer
LAYOUTS = [(1, 8, None), (2, 4, None), (8, 1, None), (1, 4, 2), (2, 2, 2), (1, 2, None),
           (1, None, None), (2, None, 2)]


@pytest.mark.parametrize("data,model,expert", LAYOUTS)
def test_rank_layout_matches_jax_make_mesh(data, model, expert):
    import jax
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu_torch.shard.mesh import axis_lines, layout_mesh, mesh_axes, rank_grid

    n = 2 if (data, model, expert) == (1, 2, None) else 8
    devices = jax.devices()[:n]
    jm = make_mesh(data=data, model=model, expert=expert, devices=devices)
    names, sizes = mesh_axes(n, data, model, expert)
    assert names == tuple(jm.axis_names) and sizes == tuple(jm.devices.shape)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    assert np.array_equal(rank_grid(sizes), ids)
    for r in range(n):
        mesh = layout_mesh(data, model, expert, rank=r, n=n)
        where = np.argwhere(ids == r)[0]
        assert [mesh.coords[a] for a in names] == list(where)
    for i in range(len(sizes)):
        lines = axis_lines(sizes, i)
        assert sorted(x for line in lines for x in line) == list(range(n))
        for line in lines:
            coords = np.array([np.unravel_index(r, sizes) for r in line])
            assert (np.delete(coords, i, axis=1) == np.delete(coords, i, axis=1)[0]).all()


# (stage, data, model, expert) over 8 devices, and over fewer
STAGE_LAYOUTS = [(2, 1, 4, None), (4, 1, 2, None), (2, 2, 2, None), (2, 1, None, 2),
                 (8, 1, 1, None), (2, 1, 1, None)]


@pytest.mark.parametrize("stage,data,model,expert", STAGE_LAYOUTS)
def test_stage_layout_matches_jax_make_mesh(stage, data, model, expert):
    """With a stage axis (outermost): rank r sits where JAX's ``make_mesh``
    puts device r, and each stage line holds the ranks that differ in their
    stage alone."""
    import jax
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu_torch.shard.mesh import axis_lines, layout_mesh, mesh_axes, rank_grid

    n = 2 if (stage, data, model) == (2, 1, 1) else 8
    devices = jax.devices()[:n]
    jm = make_mesh(data=data, model=model, expert=expert, stage=stage, devices=devices)
    names, sizes = mesh_axes(n, data, model, expert, stage)
    assert names == tuple(jm.axis_names) and names[0] == "stage"
    assert sizes == tuple(jm.devices.shape)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    assert np.array_equal(rank_grid(sizes), ids)
    for r in range(n):
        mesh = layout_mesh(data, model, expert, rank=r, n=n, stage=stage)
        assert [mesh.coords[a] for a in names] == list(np.argwhere(ids == r)[0])
    for line in axis_lines(sizes, 0):
        assert [np.unravel_index(r, sizes)[0] for r in line] == list(range(stage))


def test_mesh_refuses_as_jax_and_stage_names_its_item():
    """Sizes that do not multiply to the ranks raise, as JAX asserts: a stage
    axis of 2 over one process among them; one rank builds a mesh whose
    collectives are the identity, a stage axis of 1 included."""
    from autosmoothquant_tpu_torch.shard.mesh import make_mesh, mesh_axes

    with pytest.raises(ValueError):
        mesh_axes(8, data=3, model=3)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(stage=2, devices=["cpu"])
    staged = make_mesh(stage=1, devices=["cpu"])
    assert staged.shape == {"stage": 1, "data": 1, "model": 1}
    assert staged.axis("stage").broadcast(torch.ones(2), 0).tolist() == [1.0, 1.0]
    one = make_mesh(devices=["cpu"])
    assert one.shape == {"data": 1, "model": 1} and one.axis("model").all_reduce(
        torch.ones(2)).tolist() == [1.0, 1.0]


def _cfgs():
    """family -> (JAX cfg, port cfg) at test sizes."""
    from autosmoothquant_tpu.models import baichuan as JB
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.models import mixtral as JM
    from autosmoothquant_tpu.models import opt as JO
    from autosmoothquant_tpu_torch.models import baichuan as TB
    from autosmoothquant_tpu_torch.models import mixtral as TM

    llama = JL.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4)
    opt = JO.OPTConfig(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                       num_attention_heads=8, word_embed_proj_dim=64)
    bc = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=8, model_max_length=64)
    mc = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
              num_experts_per_tok=2)
    return {"llama": (llama, port_config(llama)), "gemma": (llama, port_config(llama)),
            "opt": (opt, port_opt_config(opt)),
            "baichuan": (JB.BaichuanConfig(**bc), TB.BaichuanConfig(**bc)),
            "mixtral": (JM.MixtralConfig(**mc), TM.MixtralConfig(**mc))}


@pytest.mark.parametrize("family", ["llama", "gemma", "opt", "baichuan", "mixtral"])
@pytest.mark.parametrize("data,model,expert", [(1, 8, None), (2, 4, None), (1, 4, 2),
                                               (2, 2, 2), (8, 1, None)])
def test_specs_match_jax_leaf_by_leaf(family, data, model, expert):
    import jax
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu.shard.sharding import kv_cache_specs as jax_kv_specs
    from autosmoothquant_tpu.shard.sharding import param_specs as jax_specs
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.sharding import kv_cache_specs, param_specs

    jcfg, tcfg = _cfgs()[family]
    jm = make_mesh(data=data, model=model, expert=expert)
    mesh = layout_mesh(data, model, expert)
    want = jax.tree.map(tuple, jax_specs(family, jcfg, jm),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert param_specs(family, tcfg, mesh) == want
    for shard_batch in (True, False):
        assert kv_cache_specs(tcfg, mesh, shard_batch) == {
            k: tuple(v) for k, v in jax_kv_specs(jcfg, jm, shard_batch).items()}


def _jax_params(case):
    """(family, JAX module, cfg, quantized JAX params, port cfg, qcfg)."""
    import jax
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ

    if case in ("llama_int8", "llama_int4"):
        JM, cfg, params, qcfg = jax_llama({"type": "int8"} if case == "llama_int8"
                                          else {"type": "int4", "group_size": 32}, seed=1)
        return "llama", JM, cfg, params, port_config(cfg), qcfg
    if case == "opt_int8":
        JM, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=1)
        return "opt", JM, cfg, params, port_opt_config(cfg), qcfg
    jcfg, tcfg = _cfgs()[case.split("_")[0]]
    if case.startswith("baichuan"):
        from autosmoothquant_tpu.models import baichuan as JM
    else:
        from autosmoothquant_tpu.models import mixtral as JM
    qcfg = JQ(type="int8") if case.endswith("int8") else JQ(type="int4", group_size=16)
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    keys = JM.layer_scales(_fake_stats(JM, jcfg)) if qcfg.is_int8 else None
    return case.split("_")[0], JM, jcfg, JM.quantize(params, qcfg, keys, cfg=jcfg), tcfg, qcfg


def _fake_stats(JM, cfg):
    """Statistics of one calibration pass over random ids."""
    from autosmoothquant_tpu.calibrate.calibrate import calibrate

    ids = [np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)]
    kw = ({"extra_forward_kwargs": JM.CALIBRATION_FORWARD_KWARGS}
          if hasattr(JM, "CALIBRATION_FORWARD_KWARGS") else {})
    return calibrate(JM, JM.init_params(cfg, __import__("jax").random.PRNGKey(2)), cfg,
                     iter(ids), **kw)


SHARD_CASES = {
    "llama_int8": [(1, 2, None), (1, 4, None), (2, 2, None)],
    "llama_int4": [(1, 2, None)],
    "opt_int8": [(1, 2, None), (1, 4, None)],
    "baichuan_int8": [(1, 2, None)],
    "mixtral_int8": [(1, 1, 2), (1, 2, 2), (1, 2, None)],
    "mixtral_int4": [(1, 1, 2), (1, 2, 2)],
}


def _port_layout(path, leaf):
    """JAX's per-layer leaf as the port lays it out."""
    a = np.asarray(leaf)
    quant = a.dtype.kind in "iu" or "float8" in str(a.dtype)
    if (path[-1] == "w" and quant) or path[-1] == "w_scales":
        return np.swapaxes(a, -1, -2)
    return a


def _as_np(t):
    return t.float().numpy() if t.dtype in (torch.bfloat16, torch.float8_e4m3fn) else t.numpy()


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_rank_shards_hold_what_jax_devices_hold(case):
    """shard_params gives rank r JAX device r's shard of every leaf (each
    layer's slice of JAX's stacked leaf, in the port's layout), except where
    the module docstring says the port differs; those leaves are held to the
    port's own rule (W_pack: q_i | k_i | v_i of the whole weight; k/v and
    int4 experts: whole)."""
    import jax
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu.shard import param_specs as jax_specs
    from autosmoothquant_tpu.shard import shard_params as jax_shard
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
    from autosmoothquant_tpu_torch.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.sharding import param_specs, shard_params, tp_plan

    family, JM, jcfg, jp, tcfg, jq = _jax_params(case)
    tq = QuantConfig.from_dict(jq.to_dict())
    full = params_from_jax(to_numpy_tree(jp), tcfg, device="cpu")
    for data, model, expert in SHARD_CASES[case]:
        n = data * model * (expert or 1)
        jm = make_mesh(data=data, model=model, expert=expert, devices=jax.devices()[:n])
        js = jax_shard(jp, jm, jax_specs(family, jcfg, jm))
        flat = jax.tree_util.tree_flatten_with_path(js)[0]
        for r in range(n):
            mesh = layout_mesh(data, model, expert, rank=r, n=n)
            plan = tp_plan(family, tcfg, mesh, tq)
            mine = shard_params(full, mesh, param_specs(family, tcfg, mesh), plan)
            dev = jm.devices.flat[r]
            for path, leaf in flat:
                keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
                shard = next(s.data for s in leaf.addressable_shards if s.device == dev)
                if keys[0] != "layers":
                    got = mine
                    for k in keys:
                        got = got[k]
                    want = _port_layout(keys, shard)
                    assert np.array_equal(_as_np(got), want), (keys, r)
                    continue
                for li in range(tcfg.num_hidden_layers):
                    got = mine["layers"][li]
                    for k in keys[1:]:
                        got = got[k]
                    whole = full["layers"][li]
                    for k in keys[1:]:
                        whole = whole[k]
                    _check_leaf(keys, _as_np(got), _as_np(whole),
                                _port_layout(keys, np.asarray(shard)[li]), plan, r)


def _check_leaf(keys, got, whole, want, plan, r):
    name = keys[-2] if len(keys) > 2 else None
    if "wpack" in keys and got.ndim and got.shape != whole.shape:
        ax = 1 if (keys[-1] == "w" and got.dtype.kind == "f" and whole.ndim == 2
                   and whole.shape[1] == 3 * whole.shape[0]) else 0
        parts = np.split(whole, 3, axis=ax)
        mine = [np.split(p, plan.model, axis=ax)[plan.index] for p in parts]
        assert np.array_equal(got, np.concatenate(mine, axis=ax)), (keys, r)
        return
    if name in ("k", "v") and plan.kv_index is not None:
        assert np.array_equal(got, whole), (keys, r)
        return
    if keys[-3:-2] == ("moe",) or (len(keys) > 3 and keys[2] == "moe"):
        if got.dtype == np.uint8 or keys[-1] == "w_scales" and whole.dtype == np.float32 \
                and got.shape[1:] == whole.shape[1:]:
            e = whole.shape[0] // plan.experts
            assert np.array_equal(got, whole[plan.expert_index * e:(plan.expert_index + 1) * e])
            return
    assert np.array_equal(got, want), (keys, r, got.shape, want.shape)


def test_plan_keeps_blocks_whole_where_they_do_not_split():
    """int4 row-parallel needs whole groups of both nibble planes a rank;
    attention whole heads; otherwise the block runs whole on every rank."""
    from autosmoothquant_tpu_torch.models.llama import LlamaConfig
    from autosmoothquant_tpu_torch.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.sharding import tp_plan

    cfg = LlamaConfig(vocab_size=101, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2)
    p = tp_plan("llama", cfg, layout_mesh(model=2))
    assert p.attn and p.mlp and not p.vocab and p.q_heads == 2 and p.kv_heads == 1
    p4 = tp_plan("llama", cfg, layout_mesh(model=4), QuantConfig(type="int4", group_size=64))
    assert not p4.mlp and not p4.attn      # 128 / 64 groups over 2 planes: 1 a plane
    p8 = tp_plan("llama", dataclasses.replace(cfg, num_attention_heads=4), layout_mesh(model=8))
    assert not p8.attn and p8.q_heads == 4


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_shard_kv_cache_holds_what_jax_devices_hold(quant):
    """A rank's slice of a whole cache (rows over "data", kv heads over
    "model", the int8 cache's scales with them) is JAX device r's shard of
    the stacked cache, layer by layer."""
    import jax
    import jax.numpy as jnp
    from autosmoothquant_tpu.models.common import KVCacheLayer, QuantKVCacheLayer
    from autosmoothquant_tpu.shard import make_mesh
    from autosmoothquant_tpu.shard.sharding import shard_kv_cache as jax_shard_kv
    from autosmoothquant_tpu_torch.models import common as TC
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh
    from autosmoothquant_tpu_torch.shard.sharding import shard_kv_cache, tp_plan

    jcfg, tcfg = _cfgs()["llama"]
    rng = np.random.default_rng(0)
    shape = (2, 4, 16, 4, 8)  # [L, B, S, H_kv, Dh]
    arrays = {n: rng.normal(size=shape[:4] if n.endswith("scale") else shape)
              .astype(np.float32) for n in ("k", "v", "k_scale", "v_scale")}
    if quant:
        for n in ("k", "v"):
            arrays[n] = np.clip(np.round(arrays[n] * 40), -128, 127).astype(np.int8)
        jcache = QuantKVCacheLayer(**{n: jnp.asarray(a) for n, a in arrays.items()})
        cls = TC.QuantKVCacheLayer
    else:
        arrays = {n: arrays[n] for n in ("k", "v")}
        jcache = KVCacheLayer(**{n: jnp.asarray(a) for n, a in arrays.items()})
        cls = TC.KVCacheLayer
    port = [cls(**{n: torch.from_numpy(a[l]) for n, a in arrays.items()}) for l in range(2)]
    jm = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    sharded = jax_shard_kv(jcache, jm, jcfg)
    for r in range(4):
        mesh = layout_mesh(2, 2, rank=r, n=4)
        mine = shard_kv_cache(port, mesh, tcfg, plan=tp_plan("llama", tcfg, mesh))
        dev = jm.devices.flat[r]
        for n in arrays:
            leaf = getattr(sharded, n)
            want = np.asarray(next(s.data for s in leaf.addressable_shards if s.device == dev))
            for l in range(2):
                assert np.array_equal(getattr(mine[l], n).numpy(), want[l]), (n, r, l)
