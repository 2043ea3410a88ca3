"""The port's HF import, pipeline and reference-checkpoint reader against
the JAX package's, on the CPU, on ``transformers``-initialized tiny models
(2 layers, hidden 64; Llama with GQA 4/2, tied or not; OPT pre-LN, and
post-LN with project_in/out) saved with ``save_pretrained``.

  - HF import: the port's ``load_hf_params`` (safetensors, a ``.bin``
    shard, a bf16 checkpoint) equals ``params_from_jax`` of JAX's, bit for
    bit.
  - Own statistics in: ``calibrate_smooth_quantize`` end to end on both
    sides, on the same float params and batches: statistics within rtol
    1e-5; int8 weights within one step on at most PIPELINE_SHARE of them;
    scales within rtol 1e-5 (the second pass's statistics differ in their
    last bits); greedy tokens (each prefill position and one decode step,
    f32) equal but where JAX's top-2 logit margin is <= 0.02, as for the
    existing W8A8 arms. fp8 e4m3 static: the observer pass's statistics
    and scales within rtol 1e-5 too (measured <= 4.4e-7: no fp8 rounding
    flipped at this size).
  - The reference's quantized checkpoints: written here from JAX-quantized
    params under the names JAX ``convert/hf.py:357-440`` reads; the port's
    ``load_any_quantized`` equals ``params_from_jax`` of JAX's
    ``load_reference_quantized``.
  - The JAX ``test_real_pipeline.py`` and ``test_fp8_observer.py`` checks,
    at this size, on the port alone: KL(float || quantized) bounds, the
    artifact round trip, generation, the observer's scales and the ignore
    patterns.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax, params_to_jax
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_util import run_jax_cached, run_port_cached, to_numpy_tree

SHAPES = {
    "llama": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  tie_word_embeddings=False),
    "llama_tied": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128, tie_word_embeddings=True),
    "opt_pre": dict(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128),
    "opt_post": dict(vocab_size=256, hidden_size=64, word_embed_proj_dim=32, ffn_dim=128,
                     num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=128,
                     do_layer_norm_before=False),
}
# int8 weights one step apart between the two pipelines (the rest equal):
# measured 0 of 73,728 (Llama) and 0 of 65,536 (OPT); statistics within
# 1.0e-6, scales within 3.7e-7 of JAX's
PIPELINE_SHARE = 1e-3
TIE_MARGIN = 0.02


def _hf_model(name):
    from transformers import LlamaConfig, LlamaForCausalLM, OPTConfig, OPTForCausalLM

    torch.manual_seed(0)
    if name.startswith("llama"):
        return LlamaForCausalLM(LlamaConfig(attn_implementation="eager", **SHAPES[name]))
    return OPTForCausalLM(OPTConfig(attn_implementation="eager", **SHAPES[name]))


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{name: directory} of each model saved as f32 safetensors, and
    "llama_bf16" (bf16 safetensors) and "llama_bin" (a pytorch_model.bin)."""
    out = {}
    for name in SHAPES:
        d = tmp_path_factory.mktemp(name)
        _hf_model(name).eval().float().save_pretrained(d, safe_serialization=True)
        out[name] = d
    model = _hf_model("llama").eval()
    out["llama_bf16"] = tmp_path_factory.mktemp("llama_bf16")
    model.to(torch.bfloat16).save_pretrained(out["llama_bf16"], safe_serialization=True)
    out["llama_bin"] = tmp_path_factory.mktemp("llama_bin")
    model.float().save_pretrained(out["llama_bin"], safe_serialization=False)
    return out


def _modules(name):
    from autosmoothquant_tpu.models import llama as JL
    from autosmoothquant_tpu.models import opt as JO
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import opt as TO

    return (JL, TL, "llama") if name.startswith("llama") else (JO, TO, "opt")


def _configs(name, d):
    from autosmoothquant_tpu.convert.hf import hf_config_dict

    JM, TM, family = _modules(name)
    config = hf_config_dict(str(d))
    return JM, TM, family, config, JM.config_from_hf(config), TM.config_from_hf(config)


def leaves(node, path=""):
    if isinstance(node, dict):
        return [x for k, v in node.items() for x in leaves(v, f"{path}/{k}")]
    if isinstance(node, list):
        return [x for i, v in enumerate(node) for x in leaves(v, f"{path}/{i}")]
    return [(path, node)]


def assert_equal_trees(want, got):
    a, b = dict(leaves(want)), dict(leaves(got))
    assert set(a) == set(b), set(a) ^ set(b)
    bad = [p for p in a if a[p].dtype != b[p].dtype or a[p].shape != b[p].shape
           or not torch.equal(a[p], b[p])]
    assert not bad, bad[:8]


# --- HF import ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "llama_tied", "opt_pre", "opt_post",
                                  "llama_bf16", "llama_bin"])
def test_load_hf_params_matches_jax(hf_dirs, name):
    from autosmoothquant_tpu.convert.hf import load_hf_params as jload
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params, load_state_dict

    d = hf_dirs[name]
    JM, TM, family, config, jcfg, tcfg = _configs(name, d)
    jfamily = "llama" if family == "llama" else "transformers"
    want = params_from_jax(to_numpy_tree(jload(str(d), jfamily, jcfg.num_hidden_layers)),
                           tcfg, device="cpu")
    got = load_hf_params(str(d), family, tcfg.num_hidden_layers, device="cpu")
    assert_equal_trees(want, got)
    assert got["layers"][0]["attn"]["q"]["w"].shape == (tcfg.hidden_size, tcfg.hidden_size)
    from_sd = load_hf_params(load_state_dict(str(d)), family, tcfg.num_hidden_layers,
                             device="cpu")
    assert_equal_trees(got, from_sd)


def test_unported_families_name_their_item():
    """Every family of the JAX package is ported: Baichuan and Gemma
    (tests/test_torch_baichuan.py, tests/test_torch_gemma.py) and Mixtral
    (tests/test_torch_mixtral.py), whose mapper reads an HF state dict; an
    architecture no package has raises ValueError listing the supported
    ones."""
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.models.registry import get_model_family

    from test_torch_util import mixtral_state_dict

    params = load_hf_params(mixtral_state_dict(), "mixtral", 1, device="cpu")
    assert params["layers"][0]["moe"]["router"]["w"].shape == (8, 2)
    with pytest.raises(ValueError, match="supported: .*MixtralForCausalLM"):
        get_model_family({"architectures": ["FalconForCausalLM"], "model_type": "falcon"})


def test_datautils_match_jax(tmp_path):
    """random_windows, synthetic_stream and load_json_text (the json module,
    not ``datasets``) give JAX's arrays."""
    from autosmoothquant_tpu.utils import datautils as JD
    from autosmoothquant_tpu_torch.utils import datautils as TD

    stream = TD.synthetic_stream(256, 4096, seed=11)
    np.testing.assert_array_equal(stream, JD.synthetic_stream(256, 4096, seed=11))
    np.testing.assert_array_equal(TD.random_windows(stream, 8, 64, seed=1),
                                  JD.random_windows(stream, 8, 64, seed=1))
    path = tmp_path / "val.jsonl"
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(5):
            f.write(json.dumps({"text": " ".join(str(x) for x in rng.integers(1, 99, 20))}) + "\n")

    class Tok:  # whitespace ids, HF-like: __call__(text).input_ids
        def __call__(self, text):
            return type("E", (), {"input_ids": [int(w) for w in text.split()]})

    np.testing.assert_array_equal(TD.load_json_text(str(path), Tok()),
                                  JD.load_json_text(str(path), Tok()))


# --- the pipeline, own statistics in ------------------------------------------


def _calib(vocab, seed=1):
    from autosmoothquant_tpu_torch.utils.datautils import random_windows, synthetic_stream

    w = random_windows(synthetic_stream(vocab, 4096, seed=11), 8, 32, seed=seed)
    return lambda: [w[:4], w[4:]]


@pytest.fixture(scope="module")
def pipelines(hf_dirs):
    """{(model, format): (JAX quantized params in the port's layout, JAX
    artifacts, the port's quantized params, the port's artifacts, JAX
    module, port module, JAX cfg, port cfg, qcfg kwargs)}, computed once."""
    from autosmoothquant_tpu.convert.hf import load_hf_params as jload
    from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize as jcsq
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import calibrate_smooth_quantize

    out = {}
    for name, fmt in (("llama", {"type": "int8"}), ("opt_pre", {"type": "int8"}),
                      ("opt_post", {"type": "int8"}),
                      ("llama", {"type": "fp8_e4m3", "activation_scheme": "static"})):
        JM, TM, family, config, jcfg, tcfg = _configs(name, hf_dirs[name])
        jparams = jload(str(hf_dirs[name]), "llama" if family == "llama" else "transformers",
                        jcfg.num_hidden_layers)
        tparams = load_hf_params(str(hf_dirs[name]), family, tcfg.num_hidden_layers,
                                 device="cpu")
        jq, jart = jcsq(JM, jparams, jcfg, JQ(**fmt), _calib(jcfg.vocab_size))
        tq, tart = calibrate_smooth_quantize(TM, tparams, tcfg, TQ(**fmt),
                                             _calib(tcfg.vocab_size))
        out[(name, fmt["type"])] = (params_from_jax(to_numpy_tree(jq), tcfg, device="cpu"),
                                    jart, tq, tart, JM, TM, jcfg, tcfg, fmt, jq)
    return out


CASES = [("llama", "int8"), ("opt_pre", "int8"), ("opt_post", "int8"), ("llama", "fp8_e4m3")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_pipeline_own_stats_matches_jax(pipelines, case):
    want, jart, got, tart, JM, TM, jcfg, tcfg, fmt, _ = pipelines[case]
    for pass_ in ("act_stats_fp", "act_stats_smoothed"):
        if jart[pass_] is None:
            assert tart[pass_] is None
            continue
        for k in TM.STAT_KEYS:
            np.testing.assert_allclose(tart[pass_][k].numpy(), np.asarray(jart[pass_][k]),
                                       rtol=1e-5, atol=0, err_msg=f"{pass_} {k}")
    a, b = dict(leaves(want)), dict(leaves(got))
    assert set(a) == set(b)
    steps = total = 0
    for p, x in a.items():
        y = b[p]
        assert x.dtype == y.dtype and x.shape == y.shape, p
        if x.dtype == torch.int8:
            d = (x.int() - y.int()).abs()
            assert int(d.max()) <= 1, p
            steps, total = steps + int((d > 0).sum()), total + d.numel()
        elif x.dtype == torch.float8_e4m3fn:
            ulp = torch.from_numpy(np.spacing(np.abs(x.float().numpy()))) * 2**20
            assert bool(((x.float() - y.float()).abs() <= ulp).all()), p  # one e4m3 step
        else:
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5, atol=0, err_msg=p)
    assert steps <= PIPELINE_SHARE * max(total, 1), (steps, total)
    assert tart["ignored_projections"] == sorted(jart["ignored_projections"])


@pytest.mark.parametrize("case", CASES[:3], ids=["-".join(c) for c in CASES[:3]])
def test_pipeline_artifacts_generate_jax_tokens(pipelines, case):
    """Greedy tokens of the two quantized models (f32; every prefill
    position and one decode step): equal but where JAX's top-2 margin is
    <= TIE_MARGIN."""
    from autosmoothquant_tpu.quant.config import QuantConfig as JQ
    import jax.numpy as jnp

    _, _, got, _, JM, TM, jcfg, tcfg, fmt, jq = pipelines[case]
    ids = np.random.default_rng(7).integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    jlg, jdec, tok = run_jax_cached(JM, jcfg, jq, JQ(**fmt), ids, jnp.float32)
    tlg, tdec = run_port_cached(TM, tcfg, got, TQ(**fmt), ids, torch.float32, tok)
    for want, have in ((jlg.reshape(-1, jlg.shape[-1]), tlg.reshape(-1, tlg.shape[-1])),
                       (jdec, tdec)):
        top2 = np.sort(want, axis=-1)[:, -2:]
        parted = want.argmax(-1) != have.argmax(-1)
        assert np.all(top2[parted, 1] - top2[parted, 0] <= TIE_MARGIN), case


# --- the reference's quantized checkpoints ------------------------------------


def _reference_state_dict(jq, family, config):
    """The reference's save_pretrained tensors of JAX-quantized int8 params
    (stacked, [in, out]): int8 weights back to [out, in], scales and biases
    per layer, by the names JAX convert/hf.py reads."""
    p = {k: v for k, v in to_numpy_tree(jq).items()}
    sd = {}
    L = config["num_hidden_layers"]
    lay = p["layers"]
    if family == "llama":
        base, names = "model.layers.{i}", {
            "attn": {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                     "v": "self_attn.v_proj", "o": "self_attn.o_proj"},
            "mlp": {"gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}}
        norms = {"ln1": "input_layernorm", "ln2": "post_attention_layernorm"}
        top = {"model.embed_tokens.weight": p["embed"]["w"], "model.norm.weight":
               p["final_norm"]["w"], "lm_head.weight": p["lm_head"]["w"].T}
    else:
        base, names = "model.decoder.layers.{i}", {
            "attn": {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                     "v": "self_attn.v_proj", "o": "self_attn.out_proj"},
            "mlp": {"fc1": "fc1", "fc2": "fc2"}}
        norms = {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm"}
        top = {"model.decoder.embed_tokens.weight": p["embed"]["w"],
               "model.decoder.embed_positions.weight": p["embed_pos"]["w"],
               "model.decoder.final_layer_norm.weight": p["final_norm"]["w"],
               "model.decoder.final_layer_norm.bias": p["final_norm"]["b"],
               "lm_head.weight": p["lm_head"]["w"].T}
    for i in range(L):
        b = base.format(i=i)
        for key, hf in norms.items():
            sd[f"{b}.{hf}.weight"] = lay[key]["w"][i]
            if "b" in lay[key]:
                sd[f"{b}.{hf}.bias"] = lay[key]["b"][i]
        for grp, projs in names.items():
            for key, hf in projs.items():
                q = lay[grp][key]
                sd[f"{b}.{hf}.weight"] = q["w"][i].T
                for leaf in ("dequant_scale", "quant_scale", "bias"):
                    if leaf in q:
                        sd[f"{b}.{hf}.{leaf}"] = q[leaf][i]
    sd.update(top)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("case", CASES[:2], ids=["-".join(c) for c in CASES[:2]])
def test_reference_checkpoint_loads_as_jax(pipelines, case, tmp_path):
    """load_any_quantized reads a reference-format checkpoint (no manifest):
    the port's params equal params_from_jax of JAX's
    load_reference_quantized, and the model serves."""
    from autosmoothquant_tpu.convert.hf import load_reference_quantized as jref
    from autosmoothquant_tpu_torch.convert.pipeline import load_any_quantized
    from autosmoothquant_tpu_torch.convert.safetensors_io import save_safetensors
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    _, _, _, _, JM, TM, jcfg, tcfg, fmt, jq = pipelines[case]
    family = "llama" if case[0] == "llama" else "opt"
    arch = {"llama": "QuantizedLlamaForCausalLM", "opt": "Int8OPTForCausalLM"}[family]
    config = {"architectures": [arch], "model_type": family, **dataclasses.asdict(tcfg)}
    save_safetensors(str(tmp_path / "model.safetensors"),
                     _reference_state_dict(jq, family, config))
    (tmp_path / "config.json").write_text(json.dumps(config))
    (tmp_path / "quant_config.json").write_text(json.dumps(TQ(**fmt).to_dict()))
    got, qcfg, got_config = load_any_quantized(str(tmp_path), device="cpu")
    want, want_q = jref(str(tmp_path), "llama" if family == "llama" else "transformers",
                        config["num_hidden_layers"])
    assert_equal_trees(params_from_jax(to_numpy_tree(want), tcfg, device="cpu"), got)
    assert qcfg.to_dict() == want_q.to_dict() and got_config == config
    toks = Engine(TM, got, tcfg, qcfg, max_batch=1, max_seq=64, kv_dtype=torch.float32,
                  compute_dtype=torch.float32, device="cpu").generate(
        [[5, 9, 2, 11]], GenerationConfig(max_new_tokens=4))
    assert len(toks[0]) == 4


# --- JAX's test_real_pipeline.py and test_fp8_observer.py, on the port ---------


def _kl(p_logits, q_logits):
    p = torch.softmax(p_logits.double(), -1)
    q = torch.softmax(q_logits.double(), -1)
    return float((p * (torch.log(p + 1e-12) - torch.log(q + 1e-12))).sum(-1).mean())


@pytest.mark.parametrize("fmt,bound", [({"type": "int8"}, 5e-3),
                                       ({"type": "int4", "group_size": 32}, 2e-2)])
def test_real_pipeline_on_hf_model(hf_dirs, tmp_path, fmt, bound):
    """HF checkpoint -> load_hf_params -> calibrate_smooth_quantize ->
    save_quantized -> load_any_quantized -> KL(float || quantized) within
    JAX's bound -> Engine.generate."""
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import (calibrate_smooth_quantize,
                                                            load_any_quantized,
                                                            save_quantized)
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    cfg = TL.config_from_hf(json.loads((hf_dirs["llama"] / "config.json").read_text()))
    params = load_hf_params(str(hf_dirs["llama"]), "llama", 2, device="cpu")
    qparams, art = calibrate_smooth_quantize(TL, params, cfg, TQ(**fmt), _calib(256))
    save_quantized(str(tmp_path), params_to_jax(qparams), TQ(**fmt), artifacts=art)
    assert (tmp_path / "layer_scales.json").exists() == (fmt["type"] == "int8")
    p2, q2, _ = load_any_quantized(str(tmp_path), device="cpu")
    assert_equal_trees(qparams, p2)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, 32))).long()
    lg_fp = TL.logits(params, TL.forward(params, ids, cfg)[0])
    lg_q = TL.logits(p2, TL.forward(p2, ids, cfg, q2)[0])
    assert _kl(lg_fp, lg_q) < bound
    eng = Engine(TL, p2, cfg, q2, max_batch=2, max_seq=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    assert len(eng.generate([[5, 9, 2, 11]], GenerationConfig(max_new_tokens=8))[0]) == 8


def test_fp8_static_observer_on_the_port(pipelines, hf_dirs):
    """The observer pass: finite positive input and output scales [L] for
    every projection, input_scale in the params and output_scale only with
    quantize_output (which changes the logits), KL(float || fp8 static)
    under JAX's 2e-2 and 5e-2 bounds."""
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import calibrate_smooth_quantize
    from autosmoothquant_tpu_torch.models import llama as TL

    _, _, qp, art, _, _, _, cfg, fmt, _ = pipelines[("llama", "fp8_e4m3")]
    for proj in ("q", "k", "v", "o", "gate", "up", "down"):
        for io in ("input", "output"):
            s = art["observer_scales"][f"{proj}_{io}_scale"]
            assert s.shape == (2,) and bool((s > 0).all()) and bool(torch.isfinite(s).all())
    q = qp["layers"][0]["attn"]["q"]
    assert "input_scale" in q and "output_scale" not in q
    params = load_hf_params(str(hf_dirs["llama"]), "llama", 2, device="cpu")
    qo, _ = calibrate_smooth_quantize(TL, params, cfg, TQ(**fmt), _calib(256),
                                      quantize_output=True)
    assert "output_scale" in qo["layers"][0]["attn"]["q"]
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(2, 16))).long()
    lg_fp = TL.logits(params, TL.forward(params, ids, cfg)[0])
    lg_q = TL.logits(qp, TL.forward(qp, ids, cfg, TQ(**fmt))[0])
    lg_qo = TL.logits(qo, TL.forward(qo, ids, cfg, TQ(**fmt))[0])
    assert _kl(lg_fp, lg_q) < 2e-2 and _kl(lg_fp, lg_qo) < 5e-2
    assert float((lg_qo - lg_q).abs().max()) > 0


def test_ignore_patterns_keep_projections_float(hf_dirs):
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import (calibrate_smooth_quantize,
                                                            resolve_ignore_keys)
    from autosmoothquant_tpu_torch.models import llama as TL

    cfg = TL.config_from_hf(json.loads((hf_dirs["llama"] / "config.json").read_text()))
    params = load_hf_params(str(hf_dirs["llama"]), "llama", 2, device="cpu")
    qp, art = calibrate_smooth_quantize(TL, params, cfg, TQ(type="fp8_e4m3"), _calib(256),
                                        ignore_patterns=("re:.*lm_head", "re:.*down_proj"))
    assert art["ignored_projections"] == ["down"]
    mlp = qp["layers"][1]["mlp"]
    assert mlp["down"]["w"].dtype == torch.float32
    assert mlp["gate"]["w"].dtype == torch.float8_e4m3fn
    h, _ = TL.forward(qp, torch.tensor([[1, 2, 3, 4]]), cfg, TQ(type="fp8_e4m3"))
    assert bool(torch.isfinite(h).all())
    with pytest.raises(ValueError, match="per-layer"):
        resolve_ignore_keys(TL, cfg, ("model.layers.0.mlp.down_proj",))
    assert resolve_ignore_keys(TL, cfg, tuple(f"model.layers.{i}.self_attn.o_proj"
                                              for i in range(2))) == frozenset({"o"})
