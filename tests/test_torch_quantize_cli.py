"""The port's ``smoothquant_model`` CLI on the CPU against the JAX one
(``examples/smoothquant_model.py``), on the pattern of ``tests/test_cli.py``:
a tiny on-disk HF Llama (and OPT) checkpoint with a word-level tokenizer and
a jsonl calibration file.

  - ``--generate-scale --quantize-model`` writes, under the reference's
    naming, an artifact that both packages' ``load_any_quantized`` read to
    the same arrays, and that the port's ``test_model`` serves; the scales
    pickle holds JAX's keys, shapes and dtypes, its arrays within rtol 1e-5
    of the JAX CLI's (measured <= 7.9e-7).
  - Either CLI's pickle fed to both CLIs' ``--quantize-model`` gives equal
    artifacts: the same files and tensor names, dtypes and shapes; int8 and
    int4 weights within one step on at most SHARE of them (the two smooth
    with differently rounded square roots: measured 0 steps); every float
    leaf within rtol 1e-5 (int8's second calibration pass sums in another
    order; measured <= 5.0e-7); quant_config.json, config.json and
    layer_scales.json equal (the last within rtol 1e-5).
  - On a post-LN OPT (opt-350m's layout) the CLI's artifact equals, bit for
    bit, that of ``calibrate_smooth_quantize`` on the same params and
    batches: both leave the model unsmoothed (the JAX CLI smooths it, a
    departure the port does not copy).
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.cli import smoothquant_model

REPO = Path(__file__).resolve().parent.parent
VOCAB = 256
SHARE = 1e-3


def _run_jax_cli(name, argv):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


def _write_hf_dir(d, name):
    """A tiny HF checkpoint of ``name`` ("llama", "opt" pre-LN or "opt_post"
    post-LN) with a word-level tokenizer and a jsonl calibration file."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (LlamaConfig, LlamaForCausalLM, OPTConfig, OPTForCausalLM,
                              PreTrainedTokenizerFast)

    torch.manual_seed(0)
    if name == "llama":
        model = LlamaForCausalLM(LlamaConfig(
            vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            tie_word_embeddings=False, attn_implementation="eager"))
    else:
        model = OPTForCausalLM(OPTConfig(
            vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128, attn_implementation="eager",
            do_layer_norm_before=name != "opt_post"))
    model.eval().float().save_pretrained(d, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({str(i): i for i in range(VOCAB)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0").save_pretrained(d)
    rng = np.random.default_rng(0)
    with open(d / "val.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"text": " ".join(
                str(x) for x in rng.integers(1, VOCAB, size=64))}) + "\n")
    return d


@pytest.fixture(scope="module", params=["llama", "opt"])
def hf_dir(request, tmp_path_factory):
    return _write_hf_dir(tmp_path_factory.mktemp(f"hf_{request.param}"), request.param)


def _argv(hf_dir, out, scales, *extra):
    return ["--model-path", str(hf_dir), "--dataset-path", str(hf_dir / "val.jsonl"),
            "--scale-output", str(scales), "--scale-input", str(scales),
            "--num-samples", "16", "--seq-len", "32", "--model-output", str(out), *extra]


@pytest.fixture(scope="module")
def port_run(hf_dir, tmp_path_factory):
    """(artifact dir, scales pickle, the CLI's report line) of the port's
    CLI with --generate-scale --quantize-model at int8."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("port_out")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        smoothquant_model.main(_argv(hf_dir, out, out / "act_scales.pkl", "--generate-scale",
                                     "--quantize-model"), device="cpu")
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    (art,) = out.glob("*-smoothquant-int8")
    return art, out / "act_scales.pkl", report


def test_port_cli_artifact_loads_in_both_packages(hf_dir, port_run, capsys):
    from autosmoothquant_tpu.convert.pipeline import load_any_quantized as jload
    from autosmoothquant_tpu_torch.cli import test_model
    from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
    from autosmoothquant_tpu_torch.convert.pipeline import load_any_quantized

    from test_torch_util import to_numpy_tree

    art, _, report = port_run
    assert art.name == f"{hf_dir.name}-smoothquant-int8"
    for f in ("asq_manifest.json", "asq_weights.safetensors", "quant_config.json",
              "config.json", "layer_scales.json"):
        assert (art / f).exists(), f
    got, qcfg, config = load_any_quantized(str(art), device="cpu")
    jparams, jq, jconfig = jload(str(art))
    from autosmoothquant_tpu_torch.models.registry import get_model_family

    cfg = get_model_family(config).config_from_hf(config)
    want = params_from_jax(to_numpy_tree(jparams), cfg, device="cpu")
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert set(want) == set(got)
    for p, a in want.items():
        assert a.dtype == got[p].dtype and torch.equal(a, got[p]), p
    assert qcfg.to_dict() == jq.to_dict() == {"qkv": "per-tensor", "out": "per-tensor",
                                              "fc1": "per-tensor", "fc2": "per-tensor",
                                              "type": "int8", "activation_scheme": "dynamic"}
    assert config == jconfig
    stages = report["smoothquant_model"]
    assert stages["device"] == "cpu" and stages["calibration_tokens"] == 16 * 32
    assert set(stages["stages_s"]) == {"load", "tokenize", "calibrate", "smooth",
                                       "calibrate_smoothed", "quantize", "save"}
    assert stages["launches"] == {"calibrate": {}, "calibrate_smoothed": {}}  # no card
    test_model.main(["--quantized-model-path", str(art), "--prompt-ids", "7,12,9,101",
                     "--max-new-tokens", "4", "--max-seq", "64"], device="cpu",
                    compute_dtype=torch.float32, kv_dtype=torch.float32)
    assert len(capsys.readouterr().out.split()) == 4


def _leaves(node, path=""):
    if isinstance(node, dict):
        return [x for k, v in node.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(node, list):
        return [x for i, v in enumerate(node) for x in _leaves(v, f"{path}/{i}")]
    return [(path, node)]


def test_scales_pickle_matches_the_jax_cli(hf_dir, port_run, tmp_path):
    _, ours, _ = port_run
    _run_jax_cli("smoothquant_model", _argv(hf_dir, tmp_path, tmp_path / "jax.pkl",
                                            "--generate-scale"))
    with open(ours, "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)


def _artifact(path):
    from autosmoothquant_tpu_torch.convert.safetensors_io import load_safetensors

    files = sorted(p.name for p in path.iterdir())
    return files, load_safetensors(str(path / "asq_weights.safetensors"))


def _unpacked(t):
    if t.dtype == torch.uint8:  # int4 nibbles: compare the signed values
        lo, hi = (t.int() & 0xF) - 8, (t.int() >> 4) - 8
        return torch.cat([lo, hi])
    return t.int()


@pytest.mark.parametrize("fmt", [["--type", "int8"], ["--type", "int4", "--group-size", "32"]])
@pytest.mark.parametrize("pickle_from", ["port", "jax"])
def test_same_pickle_gives_equal_artifacts(hf_dir, port_run, tmp_path, fmt, pickle_from):
    _, scales, _ = port_run
    if pickle_from == "jax":
        scales = tmp_path / "jax.pkl"
        _run_jax_cli("smoothquant_model", _argv(hf_dir, tmp_path / "j0", scales,
                                                "--generate-scale"))
    _run_jax_cli("smoothquant_model", _argv(hf_dir, tmp_path / "jax", scales,
                                            "--quantize-model", *fmt))
    smoothquant_model.main(_argv(hf_dir, tmp_path / "port", scales, "--quantize-model", *fmt),
                           device="cpu")
    (jdir,) = (tmp_path / "jax").iterdir()
    (tdir,) = (tmp_path / "port").iterdir()
    assert jdir.name == tdir.name
    jfiles, want = _artifact(jdir)
    tfiles, got = _artifact(tdir)
    assert jfiles == tfiles and sorted(want) == sorted(got)
    steps = total = 0
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype in (torch.int8, torch.uint8):
            d = (_unpacked(a) - _unpacked(b)).abs()
            assert int(d.max()) <= 1, k
            steps, total = steps + int((d > 0).sum()), total + d.numel()
        else:
            np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), rtol=1e-5,
                                       atol=0, err_msg=k)
    assert steps <= SHARE * total, (steps, total)
    for f in ("quant_config.json", "config.json"):
        assert json.loads((jdir / f).read_text()) == json.loads((tdir / f).read_text())
    if (jdir / "layer_scales.json").exists():
        a, b = (json.loads((d / "layer_scales.json").read_text()) for d in (jdir, tdir))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=0, err_msg=k)


def test_missing_dataset_and_cpu_only_when_asked(hf_dir, tmp_path):
    with pytest.raises(FileNotFoundError):
        smoothquant_model.main(["--model-path", str(hf_dir), "--dataset-path",
                                str(tmp_path / "none.jsonl"), "--generate-scale"],
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            smoothquant_model.main(["--model-path", str(hf_dir), "--generate-scale"])


def test_post_ln_opt_cli_equals_the_pipeline(tmp_path):
    from autosmoothquant_tpu_torch.convert.from_jax import params_to_jax
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import (calibrate_smooth_quantize,
                                                            save_quantized)
    from autosmoothquant_tpu_torch.models import opt as O
    from autosmoothquant_tpu_torch.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.utils.datautils import load_json_text, random_windows
    from autosmoothquant_tpu_torch.utils.tokenizer import load_tokenizer

    d = _write_hf_dir(tmp_path / "opt-post", "opt_post")
    smoothquant_model.main(_argv(d, tmp_path / "cli", tmp_path / "s.pkl", "--generate-scale",
                                 "--quantize-model"), device="cpu")
    (cli_dir,) = (tmp_path / "cli").iterdir()

    config = json.loads((d / "config.json").read_text())
    cfg = O.config_from_hf(config)
    assert cfg.do_layer_norm_before is False
    params = load_hf_params(str(d), "opt", 2, dtype=torch.float32, device="cpu")
    windows = random_windows(load_json_text(str(d / "val.jsonl"), load_tokenizer(str(d))),
                             16, 32, seed=42)
    qparams, art = calibrate_smooth_quantize(
        O, params, cfg, QuantConfig(type="int8"), lambda: [windows[:8], windows[8:]])
    save_quantized(str(tmp_path / "pipe"), params_to_jax(qparams), QuantConfig(type="int8"),
                   config_dict=config, artifacts=art)
    _, want = _artifact(tmp_path / "pipe")
    _, got = _artifact(cli_dir)
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        assert a.dtype == got[k].dtype and torch.equal(a, got[k]), k
    # the model was left as it is: the second pass saw the first pass's
    # model; smoothing would have moved the post-LN norms
    for k in O.STAT_KEYS:
        assert torch.equal(art["act_stats_smoothed"][k], art["act_stats_fp"][k]), k
    with open(tmp_path / "s.pkl", "rb") as f:
        stats = pickle.load(f)
    ln = params["layers"][0]["ln1"]["w"]
    assert not torch.equal(O.smooth(params, stats, 0.5)["layers"][0]["ln1"]["w"], ln)
    assert torch.equal(O.smooth(params, stats, 0.5, cfg=cfg)["layers"][0]["ln1"]["w"], ln)
