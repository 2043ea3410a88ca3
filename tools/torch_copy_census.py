#!/usr/bin/env python3
"""Which torch ops of one eager b1 decode step issue torch's copy kernels, for
the 22-layer TinyLlama-1.1B in W8A8 and fp8 e4m3 dynamic (``chip_smoke.py``'s
random weights), on one NVIDIA GPU:

    python3 tools/torch_copy_census.py

For each format it prints the step's copy kernels by name (the profiler,
CUDA activity) and the ops that copy, each with its source and result dtypes
and the innermost line of the port that called it (a ``TorchDispatchMode``:
the card's torch records no Python frames in a profile). Needs one card, and
nvcc for the kernels' build.
"""

from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def copy_census(torch, L, cfg, eng, label):
    """Which ops of one eager b1 decode step issue torch's copy kernels. The
    profiler counts the step's copy kernels by name; a dispatch mode over
    the same step counts the ops that copy (a dtype conversion, copy_,
    clone, cat, index_copy_), each by its source and result dtypes and the
    innermost line of the port that called it."""
    import collections
    import traceback

    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    copying = {"to", "_to_copy", "copy_", "clone", "cat", "index_copy_", "contiguous"}
    sites = collections.Counter()

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func).split(".")[1]
            src = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
            # in place (copy_, index_copy_), or a new tensor: .to() to the
            # dtype a tensor has returns it and copies nothing
            if name in copying and (name.endswith("_") or out is not src):
                frames = [f for f in traceback.extract_stack() if f"/{S.PKG}/" in f.filename]
                where = (f"{frames[-1].filename.split(f'/{S.PKG}/')[1]}:{frames[-1].lineno} "
                         f"{frames[-1].line}" if frames else "(no port frame)")
                dtypes = f"{str(src.dtype)[6:]}->{str(out.dtype)[6:]}"
                sites[(name, dtypes, where)] += 1
            return out

    step = S.decode_step_fn(torch, L, cfg, eng)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = collections.Counter(re.search(r"\w*[Cc]opy\w*", e.name).group(0)
                                  for e in prof.events()
                                  if e.device_type.name == "CUDA" and "copy" in e.name.lower())
    with Census():
        step()
    torch.cuda.synchronize()
    S.log(f"  copy census, one eager decode step ({label}, b1): {sum(kernels.values())} copy "
        f"kernels {dict(kernels)}; {sum(sites.values())} copying ops, by op, dtypes and the "
        f"port's line:")
    for (op, dtypes, where), count in sites.most_common(25):
        S.log(f"    {count:5d}  {op:11s} {dtypes:20s} {where[:110]}")


def main():
    import torch

    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.quant.config import QuantConfig
    from autosmoothquant_tpu_torch.serve.engine import Engine

    if not torch.cuda.is_available():
        print("torch_copy_census: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    cfg = S.tinyllama(L, 22)
    for label, qtype in (("w8a8", "int8"), ("fp8", "fp8_e4m3")):
        qcfg = QuantConfig(type=qtype)
        params = (S.draw_w8a8(cfg, seed=3, device="cuda") if qtype == "int8"
                  else S.draw_quantized(cfg, qcfg, seed=3, device="cuda"))
        eng = Engine(L, params, cfg, qcfg, max_batch=1, max_seq=512,
                     kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                     device="cuda", cuda_graph=False)
        copy_census(torch, L, cfg, eng, f"TinyLlama-1.1B {label}")
        del eng, params
    return 0


if __name__ == "__main__":
    sys.exit(main())
