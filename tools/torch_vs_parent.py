#!/usr/bin/env python3
"""Time the PyTorch port's decode GEMVs (K1 int8, K4 fp8) and its b1 decode
against another checkout's, for example the parent commit unpacked with
``git archive``, in one process on one NVIDIA GPU.

    python3 tools/torch_vs_parent.py --parent DIR [--out FILE] [--decode LABELS]
                                     [--skip-kernels]

DIR's ``autosmoothquant_tpu_torch`` is imported under another name, so each
checkout builds its kernels from its own sources and runs its own wrappers
and engine; only this checkout's plain versions and ``chip_smoke.py``'s
cases, random weights and Timer are used for both.

kernels  K1 at TinyLlama-1.1B's four and OPT-6.7B's three projections, K4 at
         TinyLlama's four, M in {1, 2, 4, 8}: both checkouts' outputs held
         against the plain version (K1 bit-equal; K4 within the f32 sum's
         bound), then timed in turns: other, this, this, other.
decode   TinyLlama-1.1B W8A8 and fp8 e4m3 dynamic (22 layers) and OPT-6.7B
         W8A8 (32 layers), or the labels ``--decode`` lists (comma-separated:
         those, "int4" and "bf16", the TinyLlama in W4A8 and bf16), one set of
         weights for both engines: greedy tokens compared (W8A8 must agree:
         K1 is exact); b1 decode tok/s
         (prompt 128, s_max 512, 64 steps, best of 3) in 10 pairs of turns,
         other first in every other pair, with the medians, the quartiles
         and the pairs this checkout won; the profiler's device-busy ms of one decode
         step and the ms of its GEMV kernels (every kernel named "gemv"); the
         engine's captured b1 decode graph: ms a replay (CUDA events over 50
         replays, in turns other, this, this, other), and the profiler's
         device kernels and device-busy ms a replay.

Every line is printed; ``--out`` (default ``build/vs_parent.json``, a
gitignored directory) gets the results as JSON; ``--skip-kernels`` leaves the
kernels part out. Needs one card, and nvcc for the builds.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402

PKG = "autosmoothquant_tpu_torch"
OTHER = "other_asq"
MS = (1, 2, 4, 8)
TURNS = ("other", "this", "this", "other") * 5  # 10 pairs, each side first in turn


def import_other(root):
    """The package of the checkout at ``root``, imported as ``other_asq``."""
    path = os.path.join(root, PKG)
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return mod


def modules(name):
    """{checkout: its module ``name`` (a path under the package)}."""
    return {"this": importlib.import_module(f"{PKG}.{name}"),
            "other": importlib.import_module(f"{OTHER}.{name}")}


def same_fields(cls, obj):
    """``obj`` (a dataclass of one checkout) as the other checkout's ``cls``."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.init})


def build(builds):
    errors = []

    def one(mod):
        try:
            mod.build_all()
        except Exception as e:  # reported below, the run stops
            errors.append(e)
    threads = [threading.Thread(target=one, args=(b,)) for b in builds.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def compare_kernels(torch, timer, gen):
    gemm, fp8 = modules("kernels.gemm"), modules("kernels.fp8")
    rows = []
    for m in MS:
        cases = [("int8", pname, S.gemm_case(
                    torch, m, k, n, S.GEMM_VARIANTS[0 if pname in ("qkv", "gate|up") else 1],
                    gen)) for (k, n), pname in zip(S.GEMM_SHAPES, S.GEMM_NAMES)]
        cases += [("int8", f"opt {pname}", S.gemm_case(torch, m, k, n,
                                                       S.OPT_GEMM_VARIANTS[pname], gen))
                  for (k, n), pname in zip(S.OPT_GEMM_SHAPES, S.OPT_GEMM_NAMES)]
        cases += [("fp8", pname, S.fp8_case(torch, m, k, n, "e4m3", S.FP8_VARIANTS[0], gen))
                  for (k, n), pname in zip(S.GEMM_SHAPES, S.GEMM_NAMES)]
        for kind, pname, c in cases:
            k, n = c["x"].shape[1], c["w"].shape[0]
            if kind == "int8":
                fns = {tree: (lambda G=G: G.int8_matmul(
                    c["x"], c["w"], c["rs"], c["cs"], c["bias"], activation=c["act"],
                    out_dtype=c["dt"])) for tree, G in gemm.items()}
                ref = S.run_gemm(c, plain=True)
            else:
                fns = {tree: (lambda F=F: F.fp8_matmul(
                    c["x"], c["w"], c["rs"], c["cs"], c["bias"], out_dtype=c["dt"]))
                    for tree, F in fp8.items()}
                ref = S.run_fp8(c, plain=True)
                tol = S.fp8_tolerance(torch, c, ref)
            how = gemm["this"].route(m, k, c["x"], c["w"])
            S.require(how == "gemv", f"{kind} {pname} M={m} takes {how}, not the GEMV")
            for tree, fn in fns.items():
                out = fn()
                torch.cuda.synchronize()
                ok = (torch.equal(out, ref) if kind == "int8"
                      else bool(((out.double() - ref.double()).abs() <= tol).all()))
                S.require(ok, f"{tree} {kind} {pname} M={m} disagrees with the plain version")
            times = {"this": [], "other": []}
            for tree in TURNS[:4]:
                times[tree].append(timer.ms(fns[tree]))
            b_ms, _ = S.bound(S.gemm_bytes(c), 2 * m * n * k, kind)
            rows.append(dict(kernel=kind, shape=pname, m=m, k=k, n=n, bound_ms=b_ms,
                             ms=times["this"], other_ms=times["other"]))
            S.log(f"  {kind} {pname:11s} M={m} K={k:<5d} N={n:<6d} this "
                  + " / ".join(f"{t:.4f}" for t in times["this"]) + " other "
                  + " / ".join(f"{t:.4f}" for t in times["other"])
                  + f" bound {b_ms:.4f}")
    return rows


def decode_tps(torch, eng, prompt, steps=64):
    """b1 decode tok/s: 64 steps, best of 3, first-token time taken off."""
    gen_cfg = sys.modules[type(eng).__module__].GenerationConfig

    def gen_s(n):
        eng.generate(prompt, gen_cfg(max_new_tokens=n))  # warm
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(prompt, gen_cfg(max_new_tokens=n))
            best = min(best, time.perf_counter() - t0)
        return best
    return steps / (gen_s(steps + 1) - gen_s(1))


def step_profile(torch, model, cfg, eng, reps=5):
    """(device-busy ms, GEMV ms, device kernels) of one b1 decode step at
    slot 128, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    ids = torch.tensor([[1]], device="cuda")
    cache = model.init_kv_cache(cfg, 1, 512, torch.bfloat16, "cuda")
    valid = torch.zeros(1, 512, dtype=torch.bool, device="cuda")
    valid[:, :129] = True
    slot = torch.full((), 128, dtype=torch.int64, device="cuda")

    def step():
        with torch.inference_mode():
            h, _ = model.forward(eng.params, ids, cfg, eng.qcfg, kv_cache=cache,
                                 cache_index=slot, kv_valid=valid,
                                 positions=slot.reshape(1, 1), compute_dtype=torch.bfloat16)
            torch.argmax(model.logits(eng.params, h)[:, 0], -1)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    gemv = sum(e.time_range.elapsed_us() for e in events if "gemv" in e.name) / reps / 1e3
    return busy, gemv, len(events) / reps


def replay_profile(torch, graph, reps=5):
    """(device-busy ms, device kernels) of one replay of ``graph``, from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3, len(events) / reps


def compare_decode(torch, label):
    """Both checkouts' b1 engines on one set of ``label``'s weights."""
    model, cfg, qcfg, params = S.serve_model(torch, label)
    family = model.__name__.rsplit(".", 1)[1]
    models = modules(f"models.{family}")
    qcfgs = {"this": qcfg,
             "other": None if qcfg is None else same_fields(
                 modules("quant.config")["other"].QuantConfig, qcfg)}
    cfgs = {"this": cfg, "other": same_fields(getattr(models["other"], type(cfg).__name__), cfg)}
    engines = {tree: E.Engine(models[tree], params, cfgs[tree], qcfgs[tree], max_batch=1,
                              max_seq=512, kv_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16, device="cuda")
               for tree, E in modules("serve.engine").items()}
    del params
    rng = torch.Generator().manual_seed(17)
    prompt = [torch.randint(0, 32000, (128,), generator=rng).tolist()]
    tokens = {tree: e.generate(prompt, sys.modules[type(e).__module__].GenerationConfig(
        max_new_tokens=32))[0] for tree, e in engines.items()}
    same = sum(a == b for a, b in zip(tokens["this"], tokens["other"]))
    if "W8A8" in label:
        S.require(tokens["this"] == tokens["other"],
                  f"{label}: greedy tokens differ between the checkouts")
    tps = {"this": [], "other": []}
    for tree in TURNS:
        tps[tree].append(decode_tps(torch, engines[tree], prompt))
    wins = sum(a > b for a, b in zip(tps["this"], tps["other"]))
    quart = {tree: statistics.quantiles(v, n=4) for tree, v in tps.items()}
    prof = {tree: step_profile(torch, models[tree], cfgs[tree], engines[tree])
            for tree in ("other", "this")}
    graphs = {tree: next(iter(e.graphs.values())).graph for tree, e in engines.items()}
    replay_ms = {"this": [], "other": []}
    for tree in TURNS[:4]:
        replay_ms[tree].append(S.timed_replays(torch, graphs[tree]))
    replay = {tree: replay_profile(torch, graphs[tree]) for tree in ("other", "this")}
    row = dict(config=label, tokens_equal=f"{same}/{len(tokens['this'])}",
               tps=tps["this"], other_tps=tps["other"], pairs_won=wins,
               tps_quartiles=quart["this"], other_tps_quartiles=quart["other"],
               busy_ms=prof["this"][0], gemv_ms=prof["this"][1],
               kernels=prof["this"][2], other_busy_ms=prof["other"][0],
               other_gemv_ms=prof["other"][1], other_kernels=prof["other"][2],
               replay_ms=replay_ms["this"], other_replay_ms=replay_ms["other"],
               replay_busy_ms=replay["this"][0], replay_kernels=replay["this"][1],
               other_replay_busy_ms=replay["other"][0], other_replay_kernels=replay["other"][1])
    S.log(f"  {label}: greedy tokens equal {row['tokens_equal']}; b1 tok/s this "
          f"{tps['this']} other {tps['other']}; quartiles this {quart['this']} other "
          f"{quart['other']}; this won {wins} of {len(tps['this'])} pairs; "
          f"decode step device busy this "
          f"{row['busy_ms']:.3f} other {row['other_busy_ms']:.3f} ms, GEMV this "
          f"{row['gemv_ms']:.3f} other {row['other_gemv_ms']:.3f} ms, device kernels "
          f"this {row['kernels']:.1f} other {row['other_kernels']:.1f}; graph replay ms this "
          + " / ".join(f"{t:.4f}" for t in replay_ms["this"]) + " other "
          + " / ".join(f"{t:.4f}" for t in replay_ms["other"])
          + f", a replay's device busy this {replay['this'][0]:.3f} other "
          f"{replay['other'][0]:.3f} ms, device kernels this {replay['this'][1]:.1f} other "
          f"{replay['other'][1]:.1f}")
    del engines
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "vs_parent.json"))
    ap.add_argument("--decode", default="W8A8,fp8 e4m3 dynamic,OPT-6.7B W8A8",
                    help="comma-separated configurations to decode (chip_smoke.serve_model's "
                         "labels, and bf16)")
    ap.add_argument("--skip-kernels", action="store_true", help="time no kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_vs_parent: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    name, smi = S.phase_device(torch)
    import_other(os.path.abspath(args.parent))
    t0 = time.perf_counter()
    build(modules("kernels._build"))
    S.log(f"built both checkouts in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kernels = None
    if not args.skip_kernels:
        S.log("== kernels (ms)")
        kernels = compare_kernels(torch, S.Timer(torch), gen)
    S.log("== decode")
    decode = [compare_decode(torch, label) for label in args.decode.split(",")]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": kernels,
                   "decode": decode}, f, indent=1)
    S.log(f"nvidia-smi: {smi}")
    S.log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
