"""Quantize an HF float checkpoint on the card: calibrate, smooth, calibrate
again, quantize and save, the port of ``examples/smoothquant_model.py`` with
its flags.

  python -m autosmoothquant_tpu_torch.cli.smoothquant_model \
      --model-path /ckpts/llama --dataset-path val.jsonl \
      --generate-scale --quantize-model --model-output /out

``--generate-scale`` calibrates the float model on ``--num-samples`` windows
of ``--seq-len`` tokens of the jsonl dataset (batches of 8) and writes the
statistics to ``--scale-output``, a pickle of numpy arrays that either
package's CLI reads. ``--quantize-model`` reads ``--scale-input``, smooths
with ``--smooth-strength``, then for int8 calibrates the smoothed model for
its static scales and for fp8 e4m3 static observes it through its fp8
forward, quantizes (``--type``) and writes the artifact the serving CLIs
load, to ``--model-output``/<model>-smoothquant-<type>: the steps after the
first pass are ``convert/pipeline.py:quantize_from_stats``, the pipeline's
own. So a post-LN OPT (opt-350m) is left unsmoothed, where the JAX
package's CLI smooths it and so changes its function.

The work runs on the card (float products in f32, TF32 off); ``main(argv,
device="cpu")`` runs the plain versions on the CPU. Each stage prints its
wall time, and the last line is one JSON object: the stage times, the
calibration tokens a pass, and each pass's kernel launches.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import time
from pathlib import Path

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True,
                   help="HF checkpoint dir (config.json + safetensors)")
    p.add_argument("--dataset-path", default="", help="jsonl calibration set")
    p.add_argument("--generate-scale", action="store_true")
    p.add_argument("--quantize-model", action="store_true")
    p.add_argument("--scale-output", default="scales/act_scales.pkl")
    p.add_argument("--scale-input", default="scales/act_scales.pkl")
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--smooth-strength", type=float, default=0.5)
    p.add_argument("--model-output", default="quantized_model")
    p.add_argument("--type", default="int8",
                   choices=["int8", "fp8", "fp8_e4m3", "fp8_e5m2", "int4"])
    p.add_argument("--activation-scheme", default="dynamic",
                   choices=["static", "dynamic"])
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument("--ignore-patterns", nargs="*", default=["re:.*lm_head"],
                   help="fp8: projections to exempt (literal or re:regex)")
    p.add_argument("--group-size", type=int, default=128,
                   help="int4: input rows per weight-scale group")
    p.add_argument("--quantize-output", action="store_true",
                   help="fp8 static: observer-tracked output re-quantization")
    return p.parse_args(argv)


SUFFIX = {"int8": "smoothquant-int8", "fp8_e5m2": "smoothquant-fp8-e5m2"}


def output_dir(args, qcfg) -> Path:
    """--model-output/<model>-smoothquant-<type>, the reference's naming."""
    suffix = SUFFIX.get(qcfg.type) or (
        f"smoothquant-fp8-e4m3-{qcfg.activation_scheme}" if qcfg.type == "fp8_e4m3"
        else f"smoothquant-int4-g{qcfg.group_size}")
    return Path(args.model_output) / f"{Path(args.model_path).name}-{suffix}"


class _Stages:
    """Wall time of each stage (the device synchronized at its end) and the
    kernel launches of each calibration pass; ``stages(name)`` is a context
    manager around one stage."""

    def __init__(self, device):
        from ..kernels.counters import launch_counters

        self.device = device
        self.counters = launch_counters()
        self.seconds, self.launches = {}, {}
        self.tokens = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name, note=""):
        from ..kernels.counters import read_counts

        self._sync()
        t0 = time.perf_counter()
        before = read_counts(self.counters)
        yield
        self._sync()
        self.seconds[name] = time.perf_counter() - t0
        print(f"[smoothquant_model] {name}: {self.seconds[name]:.2f} s{note}", flush=True)
        if name.startswith("calibrate"):
            after = read_counts(self.counters)
            self.launches[name] = {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]}
            rate = self.tokens / max(self.seconds[name], 1e-9)
            print(f"[smoothquant_model] {name}: {self.tokens} tokens, {rate:.0f} tokens/s; "
                  f"launches {self.launches[name]}", flush=True)


def main(argv=None, *, device="cuda"):
    """Run the CLI on ``device`` (the card unless the caller asks for the
    CPU)."""
    from ..calibrate.calibrate import calibrate
    from ..convert.from_jax import params_to_jax
    from ..convert.hf import hf_config_dict, load_hf_params
    from ..convert.pipeline import quantize_from_stats, save_quantized
    from ..models.registry import get_model_family
    from ..quant.config import QuantConfig
    from ..runtime import resolve_device
    from ..utils.datautils import load_json_text, random_windows
    from ..utils.tokenizer import load_tokenizer

    args = parse_args(argv)
    dev = resolve_device(device)
    if dev.type == "cuda":
        # calibration computes in f32: its products must not round to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    stages = _Stages(dev)
    config = hf_config_dict(args.model_path)
    model_mod = get_model_family(config)
    family = model_mod.__name__.rsplit(".", 1)[-1]
    cfg = model_mod.config_from_hf(config)
    with stages("load", f" ({family}, {cfg.num_hidden_layers} layers, f32 on {dev})"):
        params = load_hf_params(args.model_path, family, cfg.num_hidden_layers,
                                dtype=torch.float32, device=dev)

    if not args.dataset_path or not os.path.exists(args.dataset_path):
        print(f"Cannot find the dataset at {args.dataset_path}")
        print("Please download the dataset and put the validation set at the path")
        raise FileNotFoundError(args.dataset_path)
    with stages("tokenize"):
        tokenizer = load_tokenizer(args.tokenizer_path or args.model_path)
        stream = load_json_text(args.dataset_path, tokenizer)
        windows = random_windows(stream, args.num_samples, args.seq_len, seed=42)
    stages.tokens = (len(windows) // 8) * 8 * args.seq_len
    print(f"[smoothquant_model] {stream.size} tokens in the stream, {stages.tokens} a pass",
          flush=True)

    def batches():
        for i in range(0, len(windows), 8):
            b = windows[i:i + 8]
            if len(b) == 8:
                yield b

    if args.generate_scale:
        with stages("calibrate"):
            stats = calibrate(model_mod, params, cfg, batches(), extra_forward_kwargs=getattr(
                model_mod, "CALIBRATION_FORWARD_KWARGS", None))
        os.makedirs(os.path.dirname(args.scale_output) or ".", exist_ok=True)
        with open(args.scale_output, "wb") as f:
            pickle.dump({k: v.numpy() for k, v in stats.items()}, f)
        print(f"saved act scales -> {args.scale_output}")

    if args.quantize_model:
        with open(args.scale_input, "rb") as f:
            stats = pickle.load(f)
        qc_path = os.path.join(args.model_path, "quant_config.json")
        raw = {}
        if os.path.exists(qc_path):
            with open(qc_path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        if args.type == "int4" and "group_size" not in raw:
            raw["group_size"] = args.group_size
        qcfg = QuantConfig.from_dict(raw, default_type=args.type,
                                     default_scheme=args.activation_scheme)
        qparams, art = quantize_from_stats(
            model_mod, params, stats, cfg, qcfg, batches, args.smooth_strength,
            ignore_patterns=tuple(args.ignore_patterns),
            quantize_output=args.quantize_output, on_stage=stages)
        del params
        out = output_dir(args, qcfg)
        with stages("save"):
            save_quantized(str(out), params_to_jax(qparams), qcfg, config_dict=config,
                           artifacts={"layer_scales": art["layer_scales"]})
        print(f"saved quantized model -> {out}")

    print(json.dumps({"smoothquant_model": {
        "device": str(dev), "stages_s": stages.seconds, "calibration_tokens": stages.tokens,
        "launches": stages.launches,
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}}), flush=True)


if __name__ == "__main__":
    main()
