"""The port's CLIs (``autosmoothquant_tpu_torch/cli/serve_model.py`` and
``test_model.py``) and artifact writer on the CPU, on the pattern of
``tests/test_cli.py``: a tiny on-disk HF Llama checkpoint with a word-level
tokenizer, quantized by the JAX ``smoothquant_model`` CLI; and a W8A8 OPT
artifact (K6's plain version). ``serve_model.build(..., device="cpu")``
round-trips /generate with a text prompt; ``test_model`` on ``--prompt-ids``
prints the JAX ``test_model``'s tokens (a W8A8 parting only at a JAX top-2
margin <= 0.02); ``--tp`` above the visible cards is refused under NCCL
(ValueError), and the speculative and paged radix-tree flags serve; the port's ``save_quantized`` output loads in JAX
``load_quantized`` with equal arrays, and the reverse."""

import dataclasses
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.cli import serve_model, test_model

from test_torch_util import http_get, http_post, jax_opt, stop_server, to_numpy_tree

VOCAB = 512
REPO = Path(__file__).resolve().parent.parent
F32 = dict(device="cpu", compute_dtype=torch.float32, kv_dtype=torch.float32)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_cli(name, argv):
    old = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        _jax_cli(name).main()
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("hf_ckpt")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128,
        tie_word_embeddings=False, attn_implementation="eager")).eval().float() \
        .save_pretrained(d, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({str(i): i for i in range(VOCAB)}, unk_token="0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="0").save_pretrained(d)
    rng = np.random.default_rng(0)
    with open(d / "val.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"text": " ".join(
                str(x) for x in rng.integers(1, VOCAB, size=64))}) + "\n")
    return d


@pytest.fixture(scope="module")
def quantized_dir(hf_dir, tmp_path_factory):
    """The JAX smoothquant_model CLI's W8A8 artifact of ``hf_dir``."""
    out = tmp_path_factory.mktemp("quant_out") / "model-int8"
    _run_jax_cli("smoothquant_model", [
        "--model-path", str(hf_dir), "--dataset-path", str(hf_dir / "val.jsonl"),
        "--generate-scale", "--quantize-model",
        "--scale-output", str(out.parent / "act_scales.pkl"),
        "--scale-input", str(out.parent / "act_scales.pkl"),
        "--num-samples", "8", "--seq-len", "32", "--model-output", str(out)])
    sub = list(out.glob("*smoothquant*"))
    return sub[0] if sub else out


@pytest.fixture(scope="module")
def opt_dir(tmp_path_factory):
    """A W8A8 OPT artifact (JAX save_quantized of calibrated int8 params with
    nonzero biases and LayerNorm affine) with its config.json."""
    from autosmoothquant_tpu.convert.pipeline import save_quantized

    _, cfg, params, qcfg = jax_opt({"type": "int8"}, seed=3)
    d = tmp_path_factory.mktemp("opt_int8")
    save_quantized(str(d), params, qcfg, config_dict={
        "architectures": ["OPTForCausalLM"], "model_type": "opt", **dataclasses.asdict(cfg)})
    return d


def _serve_args(qdir, *extra):
    return serve_model.parse_args(["--quantized-model-path", str(qdir), "--port", "0",
                                   "--max-batch", "2", "--max-seq", "64",
                                   "--prefill-chunk", "0", *extra])


def test_serve_model_round_trips_text_generate(hf_dir, quantized_dir):
    """--tokenizer-path enables a text prompt; the reply's tokens are the
    port engine's own for the tokenized prompt."""
    api, httpd, family = serve_model.build(
        _serve_args(quantized_dir, "--tokenizer-path", str(hf_dir)), **F32)
    assert family == "llama"
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, out = http_post(port, "/generate", {"prompt": "7 12 9", "max_new_tokens": 4})
        assert status == 200 and len(out["tokens"]) == 4
        assert isinstance(out["text"], str) and out["text"]
        status, ids = http_post(port, "/tokenize", {"text": "7 12 9"})
        status, direct = http_post(port, "/generate", {"prompt": ids["tokens"],
                                                       "max_new_tokens": 4})
        assert direct["tokens"] == out["tokens"]
        status, models = http_post(port, "/v1/completions", {
            "prompt": "7 12 9", "max_tokens": 4, "temperature": 0.0})
        assert status == 200 and models["model"] == Path(quantized_dir).name
        assert models["choices"][0]["tokens"] == out["tokens"]
    finally:
        stop_server(api, httpd)


def _printed_ids(capsys):
    return [int(t) for t in capsys.readouterr().out.strip().split()]


def test_test_model_prints_the_jax_cli_tokens(quantized_dir, capsys):
    """Both test_model CLIs with their defaults (bf16 compute and KV cache)
    on --prompt-ids: the same new tokens, up to a parting at a JAX top-2
    margin <= 0.02."""
    prompt = [7, 12, 9, 101, 44, 3, 250]
    argv = ["--quantized-model-path", str(quantized_dir),
            "--prompt-ids", ",".join(map(str, prompt)), "--max-new-tokens", "8",
            "--max-seq", "64"]
    _run_jax_cli("test_model", argv)
    want = _printed_ids(capsys)
    test_model.main(argv, device="cpu")
    got = _printed_ids(capsys)
    assert len(want) == len(got) == 8
    if got != want:
        import jax.numpy as jnp
        from autosmoothquant_tpu.convert.pipeline import load_quantized
        from autosmoothquant_tpu.models import llama as JL

        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        params, qcfg, config = load_quantized(str(quantized_dir))
        cfg = JL.config_from_hf(config)
        h = JL.forward_jit(params, jnp.asarray([prompt + want[:j]], jnp.int32), cfg, qcfg)[0]
        top = np.sort(np.asarray(JL.logits(params, h))[0, -1])[-2:]
        assert top[1] - top[0] <= 0.02, (j, got, want)


def test_opt_artifact_through_both_clis(opt_dir, capsys, monkeypatch):
    """A W8A8 OPT artifact: test_model's tokens equal serve_model's /generate
    reply, and both ran K6 (its plain version on the CPU)."""
    from autosmoothquant_tpu_torch.models import opt as TO

    calls = {"n": 0}
    k6 = TO.fused_add_layernorm_quant

    def counted(*a, **kw):
        calls["n"] += 1
        return k6(*a, **kw)

    monkeypatch.setattr(TO, "fused_add_layernorm_quant", counted)
    prompt = [5, 17, 99, 3, 42, 8]
    test_model.main(["--quantized-model-path", str(opt_dir), "--prompt-ids",
                     ",".join(map(str, prompt)), "--max-new-tokens", "6",
                     "--max-seq", "64"], **F32)
    printed = _printed_ids(capsys)
    assert len(printed) == 6 and calls["n"] > 0
    api, httpd, family = serve_model.build(_serve_args(opt_dir), **F32)
    assert family == "opt"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        before = calls["n"]
        status, out = http_post(httpd.server_address[1], "/generate",
                                {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200 and out["tokens"] == printed
        assert calls["n"] > before
    finally:
        stop_server(api, httpd)


REFUSED = {
    # serve_model and test_model run --tp (tests/test_torch_serve_tp.py,
    # tests/test_torch_serve_sharded.py); more NCCL ranks than visible cards
    # are refused
    "serve --tp 4": (serve_model, ["--tp", "4", "--device", "cuda"], ValueError,
                     r"card\(s\) visible"),
    "test --tp 4": (test_model, ["--tp", "4", "--device", "cuda"], ValueError,
                    r"card\(s\) visible"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_flags_name_their_item(opt_dir, case):
    mod, flags, exc, match = REFUSED[case]
    argv = ["--quantized-model-path", str(opt_dir), *flags]
    if mod is test_model:
        argv += ["--prompt-ids", "1,2"]
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are visible: --tp 4 runs")
    with pytest.raises(exc, match=match):
        mod.main(argv, compute_dtype=torch.float32, kv_dtype=torch.float32)


SERVED = {
    "serve --speculative-gamma 2": ["--speculative-gamma", "2", "--speculative-ngram", "2"],
    "serve --paged": ["--paged", "--block-size", "16"],
    "test --speculative-gamma 1": ["--speculative-gamma", "1"],
}


@pytest.mark.parametrize("case", list(SERVED))
def test_speculative_and_auto_prefix_flags_serve(opt_dir, case, capsys):
    """The flags that asked for speculative decoding and the paged engine's
    radix tree now serve them: test_model --speculative-gamma prints the
    plain greedy tokens; serve_model --speculative-gamma builds a
    speculative ContinuousEngine and --paged alone a PagedEngine with its
    tree on, and either answers /generate with test_model's tokens, its
    /stats showing gamma or the tree's counters."""
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    prompt = [5, 17, 99, 3, 42, 8] * 3
    base = ["--quantized-model-path", str(opt_dir), "--prompt-ids", ",".join(map(str, prompt)),
            "--max-new-tokens", "8", "--max-seq", "64"]
    test_model.main(base, **F32)
    printed = _printed_ids(capsys)
    flags = SERVED[case]
    if case.startswith("test"):
        test_model.main(base + flags, **F32)
        assert _printed_ids(capsys) == printed
        return
    api, httpd, _ = serve_model.build(_serve_args(opt_dir, *flags), **F32)
    eng = api.engine
    paged = "--paged" in flags
    assert isinstance(eng, PagedEngine) == paged
    if paged:
        assert eng.auto_prefix and eng.speculative_gamma == 0
    else:
        assert eng.speculative_gamma == 2
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for _ in range(2):   # the second reply hits the tree on --paged
            status, out = http_post(httpd.server_address[1], "/generate",
                                    {"prompt": prompt, "max_new_tokens": 8})
            assert status == 200 and out["tokens"] == printed
        status, stats = http_get(httpd.server_address[1], "/stats")
        assert status == 200
        if paged:
            assert stats["auto_prefix_hits"] == 1 and stats["auto_prefix_blocks"] == 1
        else:
            assert stats["spec_gamma"] == 2 and 0 <= stats["spec_acceptance_ema"] <= 1
    finally:
        stop_server(api, httpd)


@pytest.mark.parametrize("flags", [["--paged", "--no-auto-prefix"], ["--no-auto-prefix"]],
                         ids=["paged", "no-auto-prefix alone"])
def test_paged_without_auto_prefix_serves(opt_dir, flags, capsys):
    """--paged --no-auto-prefix serves the paged engine (--block-size,
    --num-pages), --no-auto-prefix alone the contiguous one (it has no
    automatic prefix sharing to turn off, as in the JAX CLI); either
    replies with test_model's tokens."""
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    prompt = [5, 17, 99, 3, 42, 8]
    test_model.main(["--quantized-model-path", str(opt_dir), "--prompt-ids",
                     ",".join(map(str, prompt)), "--max-new-tokens", "6",
                     "--max-seq", "64"], **F32)
    printed = _printed_ids(capsys)
    api, httpd, _ = serve_model.build(
        _serve_args(opt_dir, *flags, "--block-size", "16", "--num-pages", "9"), **F32)
    eng = api.engine
    assert isinstance(eng, PagedEngine) == ("--paged" in flags)
    if "--paged" in flags:
        assert (eng.block_size, eng.num_pages, eng.auto_prefix) == (16, 9, False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, out = http_post(httpd.server_address[1], "/generate",
                                {"prompt": prompt, "max_new_tokens": 6})
        assert status == 200 and out["tokens"] == printed
        status, stats = http_get(httpd.server_address[1], "/stats")
        assert status == 200 and ("free_pages" in stats) == ("--paged" in flags)
    finally:
        stop_server(api, httpd)


@pytest.mark.parametrize("tp", ["0", "1"])
def test_tp_zero_or_one_is_one_card(opt_dir, tp, capsys):
    test_model.main(["--quantized-model-path", str(opt_dir), "--prompt-ids", "1,2",
                     "--max-new-tokens", "2", "--max-seq", "64", "--tp", tp], **F32)
    assert len(_printed_ids(capsys)) == 2


def test_reference_format_checkpoint_is_refused(tmp_path):
    """A reference-format directory (quant_config.json + config.json, no
    manifest) is read as the reference's checkpoint now
    (tests/test_torch_quantize_pipeline.py reads real ones): one without
    weights is refused with FileNotFoundError (Llama, Baichuan and Mixtral),
    one of an architecture no package has with ValueError listing the
    supported ones; an empty path with FileNotFoundError."""
    from autosmoothquant_tpu_torch.convert.pipeline import load_any_quantized

    (tmp_path / "quant_config.json").write_text(json.dumps({"type": "int8"}))
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["LlamaForCausalLM"],
                                                      "num_hidden_layers": 2}))
    with pytest.raises(FileNotFoundError, match="no model weights"):
        load_any_quantized(str(tmp_path), device="cpu")
    # Baichuan and Mixtral are read as the reference's checkpoints too (no
    # weights here); Falcon is an architecture no package has
    for arch in ("BaichuanForCausalLM", "MixtralForCausalLM"):
        (tmp_path / "config.json").write_text(json.dumps({"architectures": [arch],
                                                          "num_hidden_layers": 2}))
        with pytest.raises(FileNotFoundError, match="no model weights"):
            load_any_quantized(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["FalconForCausalLM"],
                                                      "num_hidden_layers": 2}))
    with pytest.raises(ValueError, match="supported: .*MixtralForCausalLM"):
        load_any_quantized(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_any_quantized(str(tmp_path / "nothing"), device="cpu")


def _flat_numpy(tree):
    from autosmoothquant_tpu_torch.convert.pipeline import flatten

    return {k: np.asarray(v) for k, v in flatten(to_numpy_tree(tree)).items()}


@pytest.mark.parametrize("which", ["llama", "opt"])
def test_port_artifact_loads_in_jax_and_back(quantized_dir, opt_dir, tmp_path, which):
    """JAX artifact -> the port's load -> params_to_jax -> the port's
    save_quantized -> JAX load_quantized: every array equal in dtype, shape
    and bits, the quant config and config.json too; and the port reads what
    it wrote back to params equal to the first load."""
    from autosmoothquant_tpu.convert.pipeline import load_quantized as jload
    from autosmoothquant_tpu_torch.convert.from_jax import params_to_jax
    from autosmoothquant_tpu_torch.convert.pipeline import load_any_quantized, save_quantized

    src = str(quantized_dir if which == "llama" else opt_dir)
    params, qcfg, config = load_any_quantized(src, device="cpu")
    save_quantized(str(tmp_path), params_to_jax(params), qcfg, config_dict=config)
    want, want_q, want_cfg = jload(src)
    got, got_q, got_cfg = jload(str(tmp_path))
    flat_w, flat_g = _flat_numpy(want), _flat_numpy(got)
    assert set(flat_w) == set(flat_g)
    for k in flat_w:
        assert flat_w[k].dtype == flat_g[k].dtype and flat_w[k].shape == flat_g[k].shape, k
        assert flat_w[k].tobytes() == flat_g[k].tobytes(), k
    assert got_q.to_dict() == want_q.to_dict() and got_cfg == want_cfg
    again, q2, _ = load_any_quantized(str(tmp_path), device="cpu")

    def leaves(node, path=""):
        if isinstance(node, dict):
            return [x for k, v in node.items() for x in leaves(v, f"{path}/{k}")]
        if isinstance(node, list):
            return [x for i, v in enumerate(node) for x in leaves(v, f"{path}/{i}")]
        return [(path, node)]

    for (pa, a), (pb, b) in zip(leaves(params), leaves(again), strict=True):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
