"""What collectives two ranks sharing one card can run: gloo and NCCL.

    python3 tools/torch_collectives_probe.py [--out FILE]

Spawns two ranks on ``cuda:0`` (``shard/mesh.py:launch``). Under gloo each
rank runs all_reduce (SUM of int32, int64, f32 and bf16, MAX of f32),
broadcast, ``Axis.all_gather`` (the zero-filled all-reduce the port uses
where gloo has no CUDA all_gather) and gloo's own all_gather on CUDA
tensors, checks every result against the values it expects, and times the
port's row-parallel payloads (median of 50 calls, host clock, synchronized).
Under NCCL it tries one all_reduce and reports what NCCL said. Prints one
JSON object (and writes it to ``--out``, where given); exits 1 where a gloo
check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gloo_rank():
    import torch
    import torch.distributed as dist

    from autosmoothquant_tpu_torch.shard.mesh import make_mesh

    mesh = make_mesh(model=2, devices=["cuda:0", "cuda:0"])
    ax = mesh.axis("model")
    r = mesh.rank
    out = {"checks": {}, "errors": {}, "ms": {}}
    for dt in (torch.int32, torch.int64, torch.float32, torch.bfloat16):
        t = torch.full((4, 3), r + 1, dtype=dt, device="cuda")
        ax.all_reduce(t)
        out["checks"][f"all_reduce_sum_{dt}"] = bool((t == 3).all())
    t = torch.tensor([1.5 + r, -7.0 * r], device="cuda")
    ax.all_reduce(t, "max")
    out["checks"]["all_reduce_max_f32"] = t.tolist() == [2.5, 0.0]
    t = torch.full((5,), float(r), device="cuda")
    dist.broadcast(t, src=1, group=ax.group)
    out["checks"]["broadcast_f32"] = bool((t == 1).all())
    g = ax.all_gather(torch.full((2, 3), float(r), device="cuda"), dim=-1)
    out["checks"]["axis_all_gather_by_reduce"] = g.tolist() == [[0.0] * 3 + [1.0] * 3] * 2
    try:
        parts = [torch.empty(3, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.full((3,), float(r), device="cuda"), group=ax.group)
        out["errors"]["gloo_cuda_all_gather"] = None
    except Exception as e:  # recorded: what gloo says to a CUDA all_gather
        out["errors"]["gloo_cuda_all_gather"] = f"{type(e).__name__}: {str(e)[:300]}"
    for label, shape, dt in (("f32_1x2048", (1, 2048), torch.float32),
                             ("i32_1x2048", (1, 2048), torch.int32),
                             ("i32_8x2048", (8, 2048), torch.int32),
                             ("f32_1x4096", (1, 4096), torch.float32),
                             ("f32_1x32000_gather", (1, 16000), torch.float32)):
        t = torch.ones(shape, dtype=dt, device="cuda")
        times = []
        for _ in range(55):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label.endswith("gather"):
                ax.all_gather(t)
            else:
                ax.all_reduce(t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms"][label] = statistics.median(times[5:])
    return out


def _nccl_rank():
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device="cuda:0")
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return {"ok": True, "value": t.tolist()}
    except Exception as e:  # recorded: NCCL's answer to two ranks on one GPU
        return {"ok": False, "error": f"{type(e).__name__}: {str(e)[:400]}"}


def main(argv=None) -> int:
    import torch

    from autosmoothquant_tpu_torch.shard.mesh import launch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    report = {"torch": torch.__version__, "device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    report["gloo"] = launch(_gloo_rank, 2, backend="gloo", timeout=300)
    report["gloo_s"] = time.perf_counter() - t0
    try:
        report["nccl"] = launch(_nccl_rank, 2, backend="nccl", timeout=120)
    except Exception as e:  # recorded: a rank that died or hung under NCCL
        report["nccl"] = f"{type(e).__name__}: {str(e)[-1500:]}"
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    ok = all(all(r["checks"].values()) for r in report["gloo"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
