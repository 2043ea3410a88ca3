#!/usr/bin/env python3
"""Time the PyTorch port's decode attention (``csrc/decode_attn.cu``) at
``chip_smoke.py``'s decode timing shapes against another checkout's (for
example the parent commit unpacked with ``git archive``), in one process on
one NVIDIA GPU.

    python3 tools/torch_decode_attn.py [--parent DIR] [--out FILE]

Each checkout's output at every ``chip_smoke.DECODE_TIMING_CASES`` shape is
first held against the plain version (``chip_smoke.decode_tol``), with row 0
bit-equal alone and in the batch, and the other checkout's output is
compared bit for bit with this one's; then each case is timed in turns
(other, this, this, other: ``chip_smoke.Timer``, the median of 50 calls a
turn, L2 flushed), beside the plain version, SDPA (bf16 contiguous cases)
and the bound. DIR's ``autosmoothquant_tpu_torch`` is imported under
another name (``tools/torch_vs_parent.py:import_other``) and builds from
its own sources.

Every line is printed; ``--out`` (default ``build/decode_attn.json``, a
gitignored directory) gets the results as JSON. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as S  # noqa: E402
from torch_vs_parent import OTHER, import_other  # noqa: E402

from autosmoothquant_tpu_torch.kernels import _build  # noqa: E402
from autosmoothquant_tpu_torch.kernels import attention as A  # noqa: E402



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "decode_attn.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_attn: needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    device = smi.stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {device}")
    _build.build_all(["decode_attn"])
    print(f"ptxas (this checkout):\n{_build.ptxas_report['decode_attn']}")
    variants = {"this": A.decode_attention}
    if args.parent:
        import_other(os.path.abspath(args.parent))
        other = __import__(f"{OTHER}.kernels.attention", fromlist=["decode_attention"])
        other_build = __import__(f"{OTHER}.kernels._build", fromlist=["build_all"])
        other_build.build_all(["decode_attn"])
        variants = {"other": other.decode_attention, **variants}
    order = list(variants)
    turns = order + order[::-1]

    timer = S.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    results, ok = [], True
    for label, kw in S.DECODE_TIMING_CASES:
        c = S.decode_case(torch, gen=gen, **kw)
        ref = S.run_decode(c, plain=True)
        kind = "f32" if ref.dtype == torch.float32 else "bf16"
        row = {"shape": label}
        outs = {}
        for name, fn in variants.items():
            outs[name], alone = S.run_decode(c, fn=fn), S.run_decode(c, rows=1, fn=fn)
            close, err = S._close(outs[name], ref, *S.decode_tol(kind, c["kv_window"]))
            bits = torch.equal(alone[0], outs[name][0])
            ok = ok and close and bits
            row[f"{name}_max_abs_err"], row[f"{name}_row0_bits"] = err, bits
        if "other" in outs:
            row["other_bits_equal_this"] = torch.equal(outs["other"], outs["this"])
        for name in turns:
            fn = variants[name]
            row.setdefault(f"{name}_ms", []).append(timer.ms(lambda: S.run_decode(c, fn=fn)))
        row["plain_ms"] = timer.ms(lambda: S.run_decode(c, plain=True), iters=10)
        row["library_ms"] = (timer.ms(S.decode_library_call(torch, c))
                             if c["table"] is None and c["k_scale"] is None else None)
        ops, nbytes = S.decode_ops_bytes(c)
        row["bound_ms"], row["bound_by"] = S.bound(nbytes, ops, "f32")
        results.append(row)
        times = "  ".join(f"{n} {' / '.join(f'{t:.4f}' for t in row[f'{n}_ms'])}"
                          for n in order)
        errs = "  ".join(f"{n} err {row[f'{n}_max_abs_err']:.3g} bits {row[f'{n}_row0_bits']}"
                         for n in order)
        if "other" in outs:
            errs += f"  other bit-equal to this {row['other_bits_equal_this']}"
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"decode_attention {label}: {times}  plain {row['plain_ms']:.4f}  SDPA {lib}  "
              f"bound {row['bound_ms']:.5f} ({row['bound_by']}); {errs}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": device, "cases": results, "ok": ok}, f, indent=1)
    print(json.dumps({"ok": ok, "device": device}))
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
