"""The Baichuan family of the port (``models/baichuan.py``, the ALiBi term of
``kernels/attention.py``) against the JAX package's, on the CPU, on tiny
models: 2 layers, hidden 256, 4 heads of 64, in ALiBi mode (Baichuan-13B)
and RoPE mode (Baichuan-7B); float weights from JAX's ``init_params`` with
norm weights redrawn N(1, 0.2) and an outlier channel in ln1.

Tolerances (max |port - JAX| of logits): float 1e-5 (f32 sums in another
order). The quantized arms agree to ~1e-6 until a last-bit difference lands
an activation on the other side of a rounding boundary (tests/test_torch_llama.py);
one int8 step then moves the logits of that position and the later ones.
The NormHead's unit rows give logits of std ~1 here (Llama's tests: 0.2-0.3),
so the limits are Llama's scaled by that: int8 0.1 (measured 0.044, per-token
prefill), fp8 and int4 0.3. The
kernels' plain versions with slopes: 2e-6 of JAX's XLA attention (f32,
biased scores up to 0.5 * 63). Quantize on the same smoothed params and
scales: every leaf bit-equal; calibration statistics within rtol 1e-5.
Generation: greedy tokens equal to JAX's Engine (float); W8A8 up to the
first near-tie (JAX's top-2 margin <= 0.02); the paged engine's equal to
the contiguous engine's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import baichuan as JB
from autosmoothquant_tpu.quant.config import QuantConfig as JQ
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.kernels import attention as A
from autosmoothquant_tpu_torch.models import baichuan as TB
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_quantize import assert_bit_equal, leaves
from test_torch_util import (one_torch_thread, run_jax_cached,  # noqa: F401
                             run_port_cached, to_numpy_tree)

TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, model_max_length=128)
QUANT = {
    "float": (None, 1e-5),
    "int8": ({"type": "int8"}, 0.1),
    "int8_per_token": ({"type": "int8", "qkv": "per-token", "out": "per-token",
                        "fc1": "per-token", "fc2": "per-token"}, 0.1),
    "fp8_e4m3": ({"type": "fp8_e4m3"}, 0.3),
    "int4": ({"type": "int4"}, 0.3),
}
NEAR_TIE = 0.02


def _cfgs(pe):
    return (JB.BaichuanConfig(**TINY, force_position_embedding=pe),
            TB.BaichuanConfig(**TINY, force_position_embedding=pe))


def _draw(cfg, seed=0):
    """JAX float params, norms N(1, 0.2), the first 4 channels of ln1 x8."""
    rng = np.random.default_rng(seed)
    params = JB.init_params(cfg, jax.random.PRNGKey(seed))
    lay = dict(params["layers"])
    for ln in ("ln1", "ln2"):
        w = 1 + 0.2 * rng.normal(size=lay[ln]["w"].shape)
        if ln == "ln1":
            w[:, :4] *= 8
        lay[ln] = {"w": jnp.asarray(w, jnp.float32)}
    return {**params, "layers": lay}


def _batches(vocab, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(2, 32)).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """get(pe, quant) -> (JAX cfg, port cfg, JAX params, port params, JAX
    qcfg, port qcfg, JAX float statistics); built once per arm."""
    from autosmoothquant_tpu.calibrate.calibrate import calibrate as jcal

    built = {}

    def get(pe, quant="float"):
        if (pe, quant) not in built:
            cfg, tcfg = _cfgs(pe)
            jp = _draw(cfg)
            stats = jcal(JB, jp, cfg, iter(_batches(cfg.vocab_size)))
            qkw = QUANT[quant][0]
            qcfg = None if qkw is None else JQ(**qkw)
            if qcfg is not None:
                scales = JB.layer_scales(stats) if qcfg.is_int8 else None
                jp = JB.quantize(JB.smooth(jp, stats, 0.5, cfg=cfg) if qcfg.is_int8 else jp,
                                 qcfg, scales, cfg=cfg)
            built[pe, quant] = (cfg, tcfg, jp, params_from_jax(to_numpy_tree(jp), tcfg,
                                                               device="cpu"),
                                qcfg, None if qkw is None else TQ(**qkw), stats)
        return built[pe, quant]
    return get


# --- config, registry, slopes


@pytest.mark.parametrize("n", [4, 8, 12, 40])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_array_equal(TB.alibi_slopes(n).numpy(), np.asarray(JB.alibi_slopes(n)))


def test_config_and_registry():
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.models.registry import get_model_family

    hf = {"architectures": ["BaichuanForCausalLM"], "vocab_size": 125696,
          "hidden_size": 5120, "intermediate_size": 13696, "num_hidden_layers": 40,
          "num_attention_heads": 40, "model_max_length": 4096, "rms_norm_eps": 1e-6}
    mod = get_model_family(hf)
    assert mod is TB and mod.FAMILY == "baichuan"
    assert get_model_family({"model_type": "baichuan"}) is TB
    assert get_model_family({"architectures": ["QuantizedBaiChuanForCausalLM"]}) is TB
    cfg = TB.config_from_hf(hf)
    want = JB.BaichuanConfig.from_hf(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.position_embedding == "ALIBI" and cfg.head_dim == 128
    assert TB.config_from_hf({**hf, "hidden_size": 4096, "num_attention_heads": 32}
                             ).position_embedding == "ROPE"
    # Mixtral is ported too (tests/test_torch_mixtral.py); an architecture
    # that no package has raises, listing the supported ones
    from autosmoothquant_tpu_torch.models import mixtral as TX

    from test_torch_util import mixtral_state_dict

    assert get_model_family({"architectures": ["MixtralForCausalLM"]}) is TX
    assert load_hf_params(mixtral_state_dict(), "mixtral", 1, device="cpu")["layers"][0]["moe"][
        "w1"]["w"].shape == (2, 8, 16)
    with pytest.raises(ValueError, match="supported: .*MixtralForCausalLM"):
        get_model_family({"architectures": ["FalconForCausalLM"]})



def test_init_params_layout():
    """The port's own random params (what chip_smoke.py serves in bf16):
    the layout forward reads, the NormHead's columns unit vectors."""
    _, tcfg = _cfgs("ALIBI")
    params = TB.init_params(tcfg, seed=3, device="cpu")
    assert len(params["layers"]) == 2
    assert params["layers"][0]["attn"]["wpack"]["w"].shape == (256, 768)
    torch.testing.assert_close(torch.linalg.vector_norm(params["lm_head"]["w"], dim=0),
                               torch.ones(TINY["vocab_size"]))
    h, _ = TB.forward(params, torch.arange(8)[None], tcfg)
    assert TB.logits(params, h).shape == (1, 8, TINY["vocab_size"])


# --- the kernels' plain versions with the ALiBi term


def _qkv(b, t, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _jax_attend(q, k, v, mask, slopes):
    from autosmoothquant_tpu.models.common import attend

    s = k.shape[1]
    bias = (jnp.asarray(slopes)[:, None, None]
            * jnp.arange(s, dtype=jnp.float32)[None, None, :])
    bias = jnp.broadcast_to(bias, (q.shape[2], q.shape[1], s))
    return np.asarray(attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), q.shape[3] ** -0.5, alibi_bias=bias))


@pytest.mark.parametrize("banded", [False, True])
def test_flash_attention_plain_alibi_matches_jax(banded):
    """K3's plain version with slopes (causal T 64; banded: a chunk of 24 at
    slot 40 over 64 columns) against JAX's XLA attend with its alibi_bias."""
    hq, d = 4, 64
    slopes = TB.alibi_slopes(hq)
    if banded:
        q, k, v = _qkv(2, 24, 64, hq, hq, d, 1)
        rows, cols = 40 + np.arange(24)[:, None], np.arange(64)[None, :]
        got = A.flash_attention_banded(*map(torch.from_numpy, (q, k, v)), 40,
                                       sm_scale=d ** -0.5, alibi_slopes=slopes)
    else:
        q, k, v = _qkv(2, 64, 64, hq, hq, d, 2)
        rows, cols = np.arange(64)[:, None], np.arange(64)[None, :]
        got = A.flash_attention(*map(torch.from_numpy, (q, k, v)), sm_scale=d ** -0.5,
                                alibi_slopes=slopes)
    mask = np.broadcast_to(cols <= rows, (2, 1) + (cols <= rows).shape)
    want = _jax_attend(q, k, v, mask, slopes.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_decode_attention_plain_alibi_matches_jax():
    """Decode attention's plain version with slopes, contiguous (rows at
    their own positions) against JAX attend at T = 1, and paged against JAX
    paged_attend(alibi_slopes=...) over shuffled pages of 8."""
    from autosmoothquant_tpu.models.common import paged_attend

    b, s, hq, d, bs = 3, 48, 4, 64, 8
    q, k, v = _qkv(b, 1, s, hq, hq, d, 3)
    pos = np.array([47, 20, 3])
    slopes = TB.alibi_slopes(hq)
    got = A.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos), scale=d ** -0.5,
                             alibi_slopes=slopes)
    mask = (np.arange(s)[None, :] <= pos[:, None])[:, None, None, :]
    want = _jax_attend(q, k, v, mask, slopes.numpy())[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)

    m = s // bs
    perm = np.random.default_rng(4).permutation(b * m)
    table = perm.reshape(b, m).astype(np.int32)
    kp, vp = (np.zeros((b * m, bs, hq, d), np.float32) for _ in range(2))
    kp[perm], vp[perm] = k.reshape(b * m, bs, hq, d), v.reshape(b * m, bs, hq, d)
    got = A.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(pos), scale=d ** -0.5,
                             table=torch.from_numpy(table), alibi_slopes=slopes)
    want = np.asarray(paged_attend(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(table), jnp.asarray(pos[:, None]), d ** -0.5,
                                   jnp.float32, alibi_slopes=jnp.asarray(slopes.numpy())))
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=2e-6, rtol=0)


# --- the model


@pytest.mark.parametrize("pe,quant", [("ALIBI", q) for q in QUANT]
                         + [("ROPE", "float"), ("ROPE", "int8")])
def test_forward_matches_jax(models, pe, quant):
    """Prefill (2 x 24) and one decode step, f32 KV cache, the logits."""
    cfg, tcfg, jp, tp, qcfg, tq, _ = models(pe, quant)
    ids = np.random.default_rng(32).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JB, cfg, jp, qcfg, ids, jnp.float32)
    t_pre, t_dec = run_port_cached(TB, tcfg, tp, tq, ids, torch.float32, tok)
    tol = QUANT[quant][1]
    np.testing.assert_allclose(t_pre, j_pre, atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


def test_int8_kv_cache_forward_matches_jax(models):
    cfg, tcfg, jp, tp, qcfg, tq, _ = models("ALIBI", "int8")
    ids = np.random.default_rng(33).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JB, cfg, jp, qcfg, ids, jnp.int8)
    t_pre, t_dec = run_port_cached(TB, tcfg, tp, tq, ids, torch.int8, tok)
    np.testing.assert_allclose(t_pre, j_pre, atol=0.1, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=0.1, rtol=0)


# --- calibration, smoothing, quantization


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_calibrate_and_scales_match_jax(models):
    from autosmoothquant_tpu_torch.calibrate.calibrate import calibrate

    cfg, tcfg, jp, tp, _, _, stats = models("ALIBI")
    got = calibrate(TB, tp, tcfg, iter(_batches(cfg.vocab_size)))
    assert tuple(got) == TB.STAT_KEYS == JB.STAT_KEYS
    for k in TB.STAT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(stats[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
    for fn in ("layer_scales", "fp8_observer_scales", "act_scales_dict"):
        want = {k: np.asarray(v) for k, v in getattr(JB, fn)(stats).items()}
        have = getattr(TB, fn)(_t(stats))
        assert list(have) == list(want), fn
        for k in want:
            np.testing.assert_array_equal(have[k].numpy(), want[k], err_msg=k)


def test_smooth_matches_jax(models):
    """Each side's smooth of JAX's statistics: weights and norms within a
    relative 2^-21 (tests/test_torch_quantize.py: JAX's powf against the
    port's sqrt, 2 ulp of s carried through one product)."""
    cfg, tcfg, jp, tp, _, _, stats = models("ALIBI")
    want = params_from_jax(to_numpy_tree(JB.smooth(jp, stats, 0.5, cfg=cfg)), tcfg, device="cpu")
    got = dict(leaves(TB.smooth(tp, stats, 0.5, cfg=tcfg)))
    for path, a in leaves(want):
        b = got[path]
        assert bool(((a.double() - b.double()).abs() <= 2.0**-21 * a.double().abs()).all()), path


FORMATS = {
    "int8": {"type": "int8"},
    "int8_per_token": QUANT["int8_per_token"][0],
    "fp8_e4m3": {"type": "fp8_e4m3"},
    "fp8_e4m3_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
    "fp8_e5m2": {"type": "fp8_e5m2"},
    "int4": {"type": "int4", "group_size": 64},
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_same_inputs_bit_equal(models, fmt):
    """JAX's smoothed params and scales through both quantizes: every leaf
    bit-equal (W_pack's per-section [3D] dequant or fp8 scale vector
    included); fp8 static also with observer scales, output scales and
    W_pack left float by the ignore keys."""
    cfg, tcfg, jp, tp, _, _, stats = models("ALIBI")
    jsm = JB.smooth(jp, stats, 0.5, cfg=cfg)
    tsm = params_from_jax(to_numpy_tree(jsm), tcfg, device="cpu")
    kws = [{}]
    if fmt == "fp8_e4m3_static":
        kws.append(dict(ignore=frozenset({"wpack"}), quantize_output=True))
    for kw in kws:
        jkw, tkw = dict(kw), dict(kw)
        if kw:
            jkw["observer_scales"] = JB.fp8_observer_scales(stats)
            tkw["observer_scales"] = TB.fp8_observer_scales(_t(stats))
        want = JB.quantize(jsm, JQ(**FORMATS[fmt]), JB.layer_scales(stats), cfg=cfg, **jkw)
        got = TB.quantize(tsm, TQ(**FORMATS[fmt]), TB.layer_scales(_t(stats)), cfg=tcfg, **tkw)
        assert_bit_equal(params_from_jax(to_numpy_tree(want), tcfg, device="cpu"), got)


def test_pipeline_artifact_round_trip(models, tmp_path):
    """calibrate_smooth_quantize (int8) on the port, saved as the artifact
    (``params_to_jax``) and loaded back through config.json's family: the
    same params, the same logits."""
    from autosmoothquant_tpu_torch.convert.from_jax import params_to_jax
    from autosmoothquant_tpu_torch.convert.pipeline import (calibrate_smooth_quantize,
                                                            load_quantized, save_quantized)

    cfg, tcfg, jp, tp, _, _, _ = models("ALIBI")
    qcfg = TQ(type="int8")
    qp, art = calibrate_smooth_quantize(TB, tp, tcfg, qcfg, lambda: iter(_batches(512)))
    hf = {"architectures": ["BaichuanForCausalLM"], **TINY}
    save_quantized(str(tmp_path), params_to_jax(qp), qcfg, config_dict=hf, artifacts=art)
    qp2, qcfg2, _ = load_quantized(str(tmp_path), device="cpu")
    assert_bit_equal(qp, qp2)
    ids = torch.from_numpy(_batches(512, 1, seed=9)[0]).long()
    cfg2 = TB.config_from_hf(hf)
    assert cfg2.position_embedding == "ALIBI"
    assert torch.equal(TB.forward(qp, ids, tcfg, qcfg)[0], TB.forward(qp2, ids, cfg2, qcfg2)[0])


# --- checkpoints


def _hf_state_dict(cfg, seed=0):
    """A random HF Baichuan state dict (numpy, [out, in] weights)."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    sd = {"model.embed_tokens.weight": rng.normal(size=(V, D)),
          "model.norm.weight": 1 + 0.1 * rng.normal(size=D),
          "lm_head.weight": rng.normal(size=(V, D))}
    for i in range(cfg.num_hidden_layers):
        b = f"model.layers.{i}"
        sd.update({f"{b}.input_layernorm.weight": 1 + 0.1 * rng.normal(size=D),
                   f"{b}.post_attention_layernorm.weight": 1 + 0.1 * rng.normal(size=D),
                   f"{b}.self_attn.W_pack.weight": rng.normal(size=(3 * D, D)),
                   f"{b}.self_attn.o_proj.weight": rng.normal(size=(D, D)),
                   f"{b}.mlp.gate_proj.weight": rng.normal(size=(I, D)),
                   f"{b}.mlp.up_proj.weight": rng.normal(size=(I, D)),
                   f"{b}.mlp.down_proj.weight": rng.normal(size=(D, I))})
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_hf_mappers_match_jax():
    """The float mapper (W_pack, the NormHead rows normalized) and the
    reference's int8 checkpoint mapper (W_pack's three section scalars as a
    [3D] vector) against JAX's: the same params, in the port's layout."""
    from autosmoothquant_tpu.convert import hf as JH
    from autosmoothquant_tpu_torch.convert import hf as TH

    cfg, tcfg = _cfgs("ALIBI")
    sd = _hf_state_dict(cfg)
    want = params_from_jax(to_numpy_tree(JH.baichuan_params_from_state_dict(sd, 2)), tcfg,
                           device="cpu")
    got = TH.load_hf_params({k: torch.from_numpy(v) for k, v in sd.items()}, "baichuan", 2,
                            device="cpu")
    for (pa, a), (pb, b) in zip(sorted(leaves(want)), sorted(leaves(got))):
        assert pa == pb
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=pa)

    rng = np.random.default_rng(1)
    qsd = {k: v for k, v in sd.items() if "proj" not in k and "W_pack" not in k}
    for i in range(2):
        b = f"model.layers.{i}"
        for name, (n, k) in (("self_attn.W_pack", (768, 256)), ("self_attn.o_proj", (256, 256)),
                             ("mlp.gate_proj", (512, 256)), ("mlp.up_proj", (512, 256)),
                             ("mlp.down_proj", (256, 512))):
            qsd[f"{b}.{name}.weight"] = rng.integers(-127, 128, (n, k)).astype(np.int8)
            if name == "self_attn.W_pack":
                for s in "qkv":
                    qsd[f"{b}.{name}.{s}_dequant_scale"] = np.float32(rng.uniform(1e-3, 1e-2))
            else:
                qsd[f"{b}.{name}.dequant_scale"] = np.float32(rng.uniform(1e-3, 1e-2))
            if name in ("self_attn.o_proj", "mlp.down_proj"):
                qsd[f"{b}.{name}.quant_scale"] = np.float32(rng.uniform(1e-2, 1e-1))
    qsd = {k: torch.as_tensor(v) for k, v in qsd.items()}
    want = params_from_jax(to_numpy_tree(JH.quantized_baichuan_params_from_state_dict(qsd, 2)),
                           tcfg, device="cpu")
    got = TH._QUANTIZED_LOADERS["baichuan"](qsd, 2, device="cpu")
    for (pa, a), (pb, b) in zip(sorted(leaves(want)), sorted(leaves(got))):
        assert pa == pb and a.dtype == b.dtype, (pa, pb, a.dtype, b.dtype)
        torch.testing.assert_close(b, a.reshape(b.shape), rtol=1e-6, atol=1e-7, msg=pa)


# --- generation


def _margin(cfg, jp, qcfg, ids):
    h, _, _ = JB.forward_jit(jp, jnp.asarray([ids], jnp.int32), cfg, qcfg)
    top = np.sort(np.asarray(JB.logits(jp, h))[0, -1])[-2:]
    return float(top[1] - top[0])


RAGGED = [[5, 9, 1, 77, 3, 8, 100, 12, 40] * 3, [7, 7, 2] * 6, [300, 1, 2, 3, 4, 5]]


@pytest.mark.parametrize("pe,quant", [("ALIBI", "float"), ("ALIBI", "int8"), ("ROPE", "float")])
def test_engine_greedy_equals_jax(models, pe, quant):
    """Engine.generate on ragged prompts: JAX's greedy tokens (float equal;
    W8A8 equal up to the first near-tie)."""
    from autosmoothquant_tpu.serve import engine as JE
    from autosmoothquant_tpu_torch.serve import engine as TE

    cfg, tcfg, jp, tp, qcfg, tq, _ = models(pe, quant)
    je = JE.Engine(JB, jp, cfg, qcfg, max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    te = TE.Engine(TB, tp, tcfg, tq, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                   compute_dtype=torch.float32, device="cpu")
    got = te.generate(RAGGED, TE.GenerationConfig(max_new_tokens=10))
    want = je.generate(RAGGED, JE.GenerationConfig(max_new_tokens=10))
    if quant == "float":
        assert got == want
        return
    for prompt, a, b in zip(RAGGED, got, want):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            assert _margin(cfg, jp, qcfg, prompt + b[:j]) <= NEAR_TIE, (j, a, b)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8])
def test_paged_equals_contiguous_alibi(models, kv):
    """The ALiBi model through the PagedEngine (pages of 16, a registered
    prefix and chunks of 16: decode attention through the table, banded K3
    over the gathered pages, a radix-tree hit) gives the ContinuousEngine's
    tokens and the static engine's; f32 and int8 pages. (Float weights: the
    CPU's int32 products of W8A8 cost 100x more under the suite's workers;
    W8A8 through both engines is chip_smoke.py's families arm.)"""
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    cfg, tcfg, jp, tp, qcfg, tq, _ = models("ALIBI", "float")
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 512, 20).tolist()
    prompts = [prefix + rng.integers(1, 512, n).tolist() for n in (9, 23)]
    prompts += [rng.integers(1, 512, n).tolist() for n in (5, 33)]
    kw = dict(max_batch=4, max_seq=96, prefill_chunk=16, steps_per_sync=4, kv_dtype=kv,
              compute_dtype=torch.float32, device="cpu")
    outs = []
    for eng in (ContinuousEngine(TB, tp, tcfg, tq, **kw),
                PagedEngine(TB, tp, tcfg, tq, block_size=16, **kw)):
        eng.register_prefix("sys", prefix)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=12, **({"prefix": "sys"} if i < 2 else {}))
        outs.append(eng.run())
    assert outs[0] == outs[1]
    static = Engine(TB, tp, tcfg, tq, max_batch=1, max_seq=96, kv_dtype=kv,
                    compute_dtype=torch.float32, device="cpu")
    for i, p in enumerate(prompts):
        assert static.generate([p], GenerationConfig(max_new_tokens=12))[0] == outs[0][i], i


def test_speculative_greedy_equals_plain_alibi(models):
    """n-gram speculation (γ 3) on the ALiBi model: plain greedy's tokens
    (a verify attends its γ + 1 queries with the slopes at their slots)."""
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    cfg, tcfg, jp, tp, qcfg, tq, _ = models("ALIBI", "float")
    eng = Engine(TB, tp, tcfg, None, max_batch=2, max_seq=96, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    prompts = [[3, 4, 5, 6] * 6, [9, 8, 7] * 5]
    plain = eng.generate(prompts, GenerationConfig(max_new_tokens=16))
    spec = eng.generate(prompts, GenerationConfig(max_new_tokens=16, speculative_gamma=3))
    assert spec == plain and eng.last_spec_stats[0] > 0


# --- the smoothquant_model CLI


def write_hf_dir(d, config, sd, vocab):
    """A tiny HF checkpoint directory: config.json, the state dict as
    model.safetensors, a word-level tokenizer of ``vocab`` words and a jsonl
    calibration file."""
    import json

    from autosmoothquant_tpu_torch.convert.safetensors_io import save_safetensors

    (d / "config.json").write_text(json.dumps(config))
    save_safetensors(str(d / "model.safetensors"), {k: torch.as_tensor(v) for k, v in sd.items()})
    return write_tokenizer_and_data(d, vocab)


def write_tokenizer_and_data(d, vocab):
    """Beside an HF checkpoint in ``d``: a word-level tokenizer of ``vocab``
    words and a jsonl calibration file."""
    import json

    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({str(i): i for i in range(vocab)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0").save_pretrained(d)
    rng = np.random.default_rng(0)
    with open(d / "val.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"text": " ".join(
                str(x) for x in rng.integers(1, vocab, size=64))}) + "\n")
    return d


def run_cli_and_serve(hf_dir, out, capsys):
    """smoothquant_model (int8, 16 x 32 calibration tokens) on ``hf_dir`` on
    the CPU, then test_model on its artifact: (artifact dir, the served
    tokens)."""
    from autosmoothquant_tpu_torch.cli import smoothquant_model, test_model

    scales = out / "act_scales.pkl"
    smoothquant_model.main(
        ["--model-path", str(hf_dir), "--dataset-path", str(hf_dir / "val.jsonl"),
         "--scale-output", str(scales), "--scale-input", str(scales), "--num-samples", "16",
         "--seq-len", "32", "--model-output", str(out), "--generate-scale", "--quantize-model"],
        device="cpu")
    (art,) = out.glob("*-smoothquant-int8")
    capsys.readouterr()
    test_model.main(["--quantized-model-path", str(art), "--prompt-ids", "7,12,9,101",
                     "--max-new-tokens", "4", "--max-seq", "64"], device="cpu",
                    compute_dtype=torch.float32, kv_dtype=torch.float32)
    return art, [int(x) for x in capsys.readouterr().out.split()]


def test_smoothquant_cli_to_served_artifact(tmp_path, capsys):
    """An HF Baichuan checkpoint (ALiBi) through the smoothquant_model CLI:
    an artifact that the JAX package's and the port's loaders read to the
    same arrays, and that test_model serves with the static engine's greedy
    tokens over the loaded params."""
    from autosmoothquant_tpu.convert.pipeline import load_any_quantized as jload
    from autosmoothquant_tpu_torch.cli import load
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    cfg, tcfg = _cfgs("ALIBI")
    hf = {"architectures": ["BaichuanForCausalLM"], "model_type": "baichuan", **TINY}
    (tmp_path / "hf").mkdir()
    hf_dir = write_hf_dir(tmp_path / "hf", hf, _hf_state_dict(cfg), TINY["vocab_size"])
    art, served = run_cli_and_serve(hf_dir, tmp_path / "out", capsys)
    model, family, pcfg, params, qcfg = load(str(art), "cpu")
    assert model is TB and family == "baichuan" and pcfg.position_embedding == "ALIBI"
    jparams, jq, _ = jload(str(art))
    want = dict(leaves(params_from_jax(to_numpy_tree(jparams), pcfg, device="cpu")))
    for path, a in leaves(params):
        assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path
    eng = Engine(TB, params, pcfg, qcfg, max_batch=1, max_seq=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    assert served == eng.generate([[7, 12, 9, 101]], GenerationConfig(max_new_tokens=4))[0]
