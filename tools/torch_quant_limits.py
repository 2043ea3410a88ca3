#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s quantize limits, on one NVIDIA GPU:

    python3 tools/torch_quant_limits.py

1. The 2-layer pipelines of the quantize phase (TinyLlama width, the same
   seeds), fp8 e4m3 static and W8A8: the relative difference of every
   statistic, pass by pass and layer by layer, between the card and the CPU;
   for fp8 also with K4 swapped for its plain version on the card (f64
   sums), K4 against that, and the CPU against itself with 1-ulp noise on
   its weights (how far a last-bit difference alone carries).
2. The 22-layer TinyLlama through the smoothquant_model CLI at its
   defaults, as the phase runs it, then KL(float || model) of the held-out
   prompts for the artifact, the smoothed float model and planted faults:
   layer_scales scaled in one layer or all, one projection's weight scale
   sign-flipped or x1.1, and no smoothing.

Prints one JSON line per comparison, then one line per KL reading. Needs one
card, and nvcc for the kernels' build.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def tree_map(f, node):
    if isinstance(node, dict):
        return {k: tree_map(f, v) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_map(f, v) for v in node]
    return f(node)


def stats_by_layer(torch, L, a, b):
    """{"pass key": [rel diff of layer i]} between two pipelines' artifacts."""
    return {f"{p} {k}": [S.rel_diff(torch, a[p][k][i], b[p][k][i])
                         for i in range(a[p][k].shape[0])]
            for p in ("act_stats_fp", "act_stats_smoothed") if a[p] is not None
            for k in L.STAT_KEYS}


def pipeline_spread(torch):
    from autosmoothquant_tpu_torch.convert.pipeline import calibrate_smooth_quantize
    from autosmoothquant_tpu_torch.kernels import fp8 as K4
    from autosmoothquant_tpu_torch.models import common
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    gen = torch.Generator().manual_seed(29)   # the phase's seeds and draws
    cfg = S.tinyllama(L, 2)
    ids = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    fl = S.draw_hf_float(torch, L, cfg, seed=31)

    def run(params, device, qcfg):
        return calibrate_smooth_quantize(L, S.to_device(params, device), cfg, qcfg,
                                         lambda: [ids])[1]

    def show(pair, a, b):
        print(json.dumps({"pair": pair, "rel": stats_by_layer(torch, L, a, b)}), flush=True)

    for label, qcfg in (("fp8 e4m3 static", QuantConfig(type="fp8_e4m3",
                                                         activation_scheme="static")),
                        ("W8A8", QuantConfig(type="int8"))):
        cpu, card = run(fl, "cpu", qcfg), run(fl, "cuda", qcfg)
        show(f"{label}: card vs CPU", cpu, card)
        if qcfg.type == "fp8_e4m3":
            kernel = common.fp8_matmul
            common.fp8_matmul = K4.fp8_matmul_plain
            try:
                plain = run(fl, "cuda", qcfg)
            finally:
                common.fp8_matmul = kernel
            show(f"{label}: card with K4's plain version (f64 sums) vs CPU", cpu, plain)
            show(f"{label}: card, K4 vs its plain version", plain, card)
        g = torch.Generator().manual_seed(7)
        noisy = tree_map(lambda t: t * (1 + torch.randint(-1, 2, t.shape, generator=g).float()
                                        * 2**-23) if t.ndim == 2 else t, fl)
        show(f"{label}: CPU vs CPU with 1-ulp weight noise", cpu, run(noisy, "cpu", qcfg))


def kl_of_faults(torch):
    import numpy as np

    from autosmoothquant_tpu_torch.convert.hf import load_hf_params
    from autosmoothquant_tpu_torch.convert.pipeline import load_any_quantized
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.utils.datautils import random_windows
    from autosmoothquant_tpu_torch.utils.tokenizer import load_tokenizer

    cfg = S.tinyllama(L, 22)
    with tempfile.TemporaryDirectory(prefix="asq_limits_") as tmp:
        ckpt, out = os.path.join(tmp, "TinyLlama-1.1B"), os.path.join(tmp, "out")
        os.makedirs(ckpt)
        S.write_hf_checkpoint(torch, ckpt, S.tinyllama_config_dict(), seed=21)
        S.write_tokenizer(ckpt, cfg.vocab_size)
        calib = os.path.join(tmp, "calib.jsonl")
        with open(calib, "w", encoding="utf-8") as f:
            for text in S.synthetic_text(1, S.CALIB_RECORDS):
                f.write(json.dumps({"text": text}) + "\n")
        _, report, wall = S.run_quantize_cli(ckpt, calib, out)
        print(f"smoothquant_model {wall:.1f} s wall: {json.dumps(report)}", flush=True)
        (art,) = [os.path.join(out, d) for d in os.listdir(out) if d.endswith("int8")]
        tok = load_tokenizer(ckpt)
        stream = np.asarray(tok("\n\n".join(S.synthetic_text(2, 60))).input_ids, np.int32)
        held = torch.from_numpy(random_windows(stream, *S.KL_PROMPTS, seed=3)).long().cuda()
        fparams = load_hf_params(ckpt, "llama", cfg.num_hidden_layers, device="cuda")
        lg_fp = S.last_token_logits(torch, L, fparams, cfg, None, held)

        def kl(name, params, qcfg):
            lg = S.last_token_logits(torch, L, params, cfg, qcfg, held)
            agree = float((lg_fp.argmax(-1) == lg.argmax(-1)).float().mean())
            print(f"KL {name}: {S.softmax_kl(torch, lg_fp, lg):.6g} (top-1 agreement "
                  f"{agree:.3f})", flush=True)

        with open(os.path.join(out, "act_scales.pkl"), "rb") as f:
            stats = pickle.load(f)
        smoothed = L.smooth(fparams, stats, 0.5, cfg=cfg)
        kl("smoothed float model", smoothed, None)
        qparams, qcfg, _ = load_any_quantized(art, device="cuda")
        kl("the artifact", qparams, qcfg)
        del qparams
        with open(os.path.join(art, "layer_scales.json"), "r", encoding="utf-8") as f:
            scales = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
                      for k, v in json.load(f).items()}
        w8a8 = QuantConfig(type="int8")

        def scaled(factor, layers):
            out = {k: v.clone() for k, v in scales.items()}
            for v in out.values():
                v[layers] *= factor
            return out

        every = list(range(cfg.num_hidden_layers))
        for name, sc in (("layer_scales x2 in layer 0", scaled(2.0, [0])),
                         ("layer_scales x2 in layer 11", scaled(2.0, [11])),
                         ("layer_scales x0.5 in layer 11", scaled(0.5, [11])),
                         ("layer_scales x2 in every layer", scaled(2.0, every)),
                         ("layer_scales x4 in every layer", scaled(4.0, every))):
            kl(name, L.quantize(smoothed, w8a8, sc, cfg=cfg), w8a8)
        unsmoothed = L.layer_scales({k: torch.as_tensor(v) for k, v in stats.items()})
        kl("no smoothing (the float pass's scales)",
           L.quantize(fparams, w8a8, unsmoothed, cfg=cfg), w8a8)
        qp = L.quantize(smoothed, w8a8, scales, cfg=cfg)
        for block, proj in (("mlp", "down"), ("attn", "o")):
            p = qp["layers"][11][block][proj]
            keep = p["dequant_scale"]
            for name, scale in (("sign-flipped", -keep), ("x1.1", keep * 1.1)):
                p["dequant_scale"] = scale
                kl(f"layer 11 {proj} weight scale {name}", qp, w8a8)
            p["dequant_scale"] = keep


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_quant_limits: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S.phase_build()
    pipeline_spread(torch)
    kl_of_faults(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
