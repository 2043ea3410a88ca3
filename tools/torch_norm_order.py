#!/usr/bin/env python3
"""How far a model's tokens and logits move when its RMSNorms take
``csrc/rmsnorm_quant.cu``'s sum order instead of torch's mean, on the CPU.

    python3 tools/torch_norm_order.py [--format int4] [--threads 4]

The 2-layer TinyLlama-width model and prompts of ``chip_smoke.py``'s e2e
phase (the same seeds), f32 activations and cache, run twice on the CPU:
once with ``rmsnorm_quant``'s plain version (torch's mean: what the CPU side
of the e2e phase computes) and once with ``chip_smoke.rmsnorm_quant_ordered``
(the kernel's arithmetic, bit-equal to the card's norms). Everything else is
the plain versions on both sides, so the difference is the norms' sum order
alone. Every norm goes through ``rmsnorm_quant``, those before int4
projections too (which ``models/common.py:norm_dtype`` keeps on torch ops
for this reason), f32 out. Prints, for the equal batch's rows, where greedy decode (16 new
tokens) parts and, teacher-forced on the plain run's tokens, each step's
max |logit diff| and the plain run's top-2 margin. ``--format``: W8A8,
"fp8 e4m3 dynamic" or int4 (chip_smoke.e2e_models' labels).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--format", default="int4")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import torch

    from autosmoothquant_tpu_torch.kernels import fused
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.serve.engine import (Engine, GenerationConfig,
                                                        maybe_fuse_projections)

    torch.set_num_threads(args.threads)
    cfg = S.tinyllama(L, 2)
    rng = torch.Generator().manual_seed(11)  # phase_e2e's prompts
    [torch.randint(0, cfg.vocab_size, (n,), generator=rng) for n in (48, 40, 33, 20)]
    equal = [torch.randint(0, cfg.vocab_size, (32,), generator=rng).tolist() for _ in range(2)]
    (_, qcfg, params, _), = [m for m in S.e2e_models(torch, cfg) if m[0] == args.format]
    plain, norm_dtype = fused.rmsnorm_quant_plain, L.norm_dtype
    L.norm_dtype = lambda prescaled, projs: norm_dtype(prescaled, projs) or torch.float32

    def generate(norm):
        fused.rmsnorm_quant_plain = norm
        eng = Engine(L, params, cfg, qcfg, max_batch=4, max_seq=128, kv_dtype=torch.float32,
                     compute_dtype=torch.float32, device="cpu")
        return eng.generate(equal, GenerationConfig(max_new_tokens=16))

    def teacher_forced(norm, prompt, toks):
        """Each decode step's logits, fed the tokens ``toks``."""
        fused.rmsnorm_quant_plain = norm
        fp = maybe_fuse_projections(L, params)
        cache = L.init_kv_cache(cfg, 1, 128, torch.float32, "cpu")
        out = []
        with torch.inference_mode():
            h, _ = L.forward(fp, torch.tensor([prompt]), cfg, qcfg, kv_cache=cache,
                             cache_index=0, compute_dtype=torch.float32)
            out.append(L.logits(fp, h[:, -1:])[0, 0])
            for j, t in enumerate(toks):
                h, _ = L.forward(fp, torch.tensor([[t]]), cfg, qcfg, kv_cache=cache,
                                 cache_index=len(prompt) + j, compute_dtype=torch.float32)
                out.append(L.logits(fp, h)[0, 0])
        return out

    try:
        a, b = generate(plain), generate(S.rmsnorm_quant_ordered)
        for i, prompt in enumerate(equal):
            j = next((k for k, (x, y) in enumerate(zip(a[i], b[i])) if x != y), None)
            print(f"{args.format} equal row {i}: plain {a[i]}; ordered {b[i]}; "
                  f"parts at step {j}", flush=True)
            steps = len(a[i]) - 1 if j is None else j
            la = teacher_forced(plain, prompt, a[i][:steps])
            lb = teacher_forced(S.rmsnorm_quant_ordered, prompt, a[i][:steps])
            for k, (x, y) in enumerate(zip(la, lb)):
                top = torch.topk(x, 2).values
                print(f"  step {k}: max |logit diff| {float((x - y).abs().max()):.4g}; plain "
                      f"top-2 margin {float(top[0] - top[1]):.4g}; argmax plain "
                      f"{int(x.argmax())} ordered {int(y.argmax())}", flush=True)
    finally:
        fused.rmsnorm_quant_plain, L.norm_dtype = plain, norm_dtype
    return 0


if __name__ == "__main__":
    sys.exit(main())
