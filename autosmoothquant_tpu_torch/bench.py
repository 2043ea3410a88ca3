"""The port's bench arm: decode tokens per second of W8A8 int8 against bf16
on one card, the port of the default arm of the repository's top-level
``bench.py`` (which times the JAX engine).

    python -m autosmoothquant_tpu_torch.bench [--device cuda]

Environment, with ``bench.py``'s names and defaults: ``ASQ_BENCH_PRESET``
(``tinyllama``; also ``tiny``, ``llama7b``, ``llama13b``), ``ASQ_BENCH_BATCH``
(1), ``ASQ_BENCH_PROMPT`` (128 tokens) and ``ASQ_BENCH_SMAX`` (512). Greedy
decode through ``Engine.generate`` (a CUDA graph a step on the card), bf16
compute and KV cache, random weights from a seed: W8A8 first, then bf16,
never both at once. tok/s across the batch is batch x 64 / the time of the
64 decode steps of a 65-token generate (prefill and the first token left
out), the best of 3 after a warm call. Prints one JSON line with
``bench.py``'s keys (``metric``, ``value``, ``unit``, ``vs_baseline`` =
int8 / bf16, ``bf16_tok_per_s``) and the device it ran on.

On an H100 a graph's step runs at one of two speeds, with the same kernels
and clocks: a TinyLlama W8A8 b1 replay takes 3.57-3.65 ms or 3.09-3.16 ms,
the slower one mostly right after a capture (PERF.md, sections 6 and 7).
What switches it is not known. This arm times each engine right after its
capture and reads whichever speed the step runs at then (both have been
seen), so its figure is not to be adopted as a benchmark cell until that
speed is pinned or explained.

Weights: W8A8 draws the int8 representation directly (uniform int8 weights,
f32 scales), with scales chosen so activations keep unit scale through any
depth: norm weights (which carry the folded input scale) are ``ACT_RMS``, so
a quantized activation has an RMS near 32; each GEMM's dequant scale is
1 / (sqrt(K) * 32 * 73.6), 73.6 being the RMS of a uniform int8 weight, so
its output has unit variance; o_proj and down_proj quantize their inputs
with a static scale of 1/64. bf16 draws N(0, 1/K) weights with norm weights
1. ``chip_smoke.py`` draws its Llama models with the same functions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .models import llama as L
from .quant.config import QuantConfig
from .runtime import resolve_device
from .serve.engine import Engine, GenerationConfig

INT8_RMS = 73.6     # RMS of an integer drawn uniformly from [-127, 127]
ACT_RMS = 32.0      # RMS of a quantized activation (norm weight 32)

# bench.py's presets, as the port's LlamaConfigs
PRESETS = {
    "tiny": dict(vocab_size=2048, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                 max_position_embeddings=512),
    "tinyllama": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                      num_hidden_layers=22, num_attention_heads=32,
                      num_key_value_heads=4, max_position_embeddings=2048),
    "llama7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=32, max_position_embeddings=2048),
    "llama13b": dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                     num_hidden_layers=40, num_attention_heads=40,
                     num_key_value_heads=40, max_position_embeddings=2048),
}
DECODE_STEPS = 64


def get_cfg(preset: str) -> L.LlamaConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; one of {sorted(PRESETS)}")
    return L.LlamaConfig(**PRESETS[preset])


def draw_w8a8(cfg, seed, device):
    """Random W8A8 params in the port's layout (int8 weights [N, K])."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_attention_heads * cfg.head_dim
    KVD = cfg.num_key_value_heads * cfg.head_dim

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def proj(k, n, scaled=False):
        p = {"w": torch.randint(-127, 128, (n, k), dtype=torch.int8,
                                device=device, generator=g),
             "dequant_scale": f32(1.0 / (math.sqrt(k) * ACT_RMS * INT8_RMS))}
        if scaled:
            p["quant_scale"] = f32(1.0 / 64)
        return p

    def norm():
        return {"w": torch.full((D,), ACT_RMS, dtype=torch.float32, device=device)}

    layers = [{"ln1": norm(),
               "attn": {"q": proj(D, HD), "k": proj(D, KVD), "v": proj(D, KVD),
                        "o": proj(HD, D, scaled=True)},
               "ln2": norm(),
               "mlp": {"gate": proj(D, I), "up": proj(D, I),
                       "down": proj(I, D, scaled=True)}}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": {"w": torch.randn(V, D, generator=g, device=device)
                      .to(torch.bfloat16)},
            "layers": layers,
            "final_norm": {"w": torch.ones(D, dtype=torch.float32, device=device)},
            "lm_head": {"w": (torch.randn(D, V, generator=g, device=device)
                              * (2.0 / math.sqrt(D))).to(torch.bfloat16)}}


def draw_float(cfg, seed, device, proj_dtype=None):
    """Random float params ([in, out] weights N(0, 1/K), norm weights 1;
    bf16 embedding and lm_head). Projections are bf16, or ``proj_dtype``."""
    proj_dtype = proj_dtype or torch.bfloat16
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    HD = cfg.num_attention_heads * cfg.head_dim
    KVD = cfg.num_key_value_heads * cfg.head_dim

    def w(k, n, scale=None, dtype=proj_dtype):
        s = scale if scale is not None else 1.0 / math.sqrt(k)
        return {"w": (torch.randn(k, n, generator=g, device=device) * s)
                .to(dtype)}

    ones = lambda: {"w": torch.ones(D, dtype=torch.float32, device=device)}  # noqa: E731
    layers = [{"ln1": ones(),
               "attn": {"q": w(D, HD), "k": w(D, KVD), "v": w(D, KVD), "o": w(HD, D)},
               "ln2": ones(),
               "mlp": {"gate": w(D, I), "up": w(D, I), "down": w(I, D)}}
              for _ in range(cfg.num_hidden_layers)]
    return {"embed": {"w": torch.randn(V, D, generator=g, device=device)
                      .to(torch.bfloat16)},
            "layers": layers, "final_norm": ones(),
            "lm_head": w(D, V, scale=2.0 / math.sqrt(D), dtype=torch.bfloat16)}


def decode_tps(eng: Engine, prompts, steps: int = DECODE_STEPS) -> float:
    """Greedy decode tok/s across the batch: len(prompts) x steps over the
    time of the decode steps of a (steps + 1)-token generate (its prefill
    and first token left out), the best of 3 after a warm call; host clock,
    with the device synchronized on either side of the steps. (A difference
    of two generates' times, one of steps + 1 tokens and one of 1, goes
    negative when the host is loaded.)"""
    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    seconds = []
    decode = eng._decode

    def timed_decode(*args):
        sync()
        t0 = time.perf_counter()
        decode(*args)
        sync()
        seconds.append(time.perf_counter() - t0)

    eng._decode = timed_decode
    try:
        for _ in range(4):  # a warm call (first-call work, the graph's capture), then 3
            eng.generate(prompts, GenerationConfig(max_new_tokens=steps + 1))
    finally:
        del eng._decode
    return len(prompts) * steps / min(seconds[1:])


def run(preset: str, batch: int, prompt_len: int, s_max: int, device) -> dict:
    """The bench's result line for one configuration (see the module)."""
    dev = resolve_device(device)
    cfg = get_cfg(preset)
    if prompt_len + DECODE_STEPS + 1 > s_max:
        raise ValueError(f"prompt {prompt_len} + {DECODE_STEPS + 1} tokens exceed "
                         f"s_max {s_max}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, prompt_len)).tolist()

    def tps(params, qcfg):
        eng = Engine(L, params, cfg, qcfg, max_batch=batch, max_seq=s_max,
                     kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=dev)
        return decode_tps(eng, prompts)

    tps_int8 = tps(draw_w8a8(cfg, seed=1, device=dev), QuantConfig(type="int8"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the int8 model's memory, before bf16's
    tps_bf16 = tps(draw_float(cfg, seed=0, device=dev), None)
    return {
        "metric": f"decode_tok_per_s_w8a8_int8_{preset}_b{batch}",
        "value": round(tps_int8, 2),
        "unit": "tok/s",
        "vs_baseline": round(tps_int8 / tps_bf16, 4),
        "bf16_tok_per_s": round(tps_bf16, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(run(os.environ.get("ASQ_BENCH_PRESET", "tinyllama"),
                         int(os.environ.get("ASQ_BENCH_BATCH", "1")),
                         int(os.environ.get("ASQ_BENCH_PROMPT", "128")),
                         int(os.environ.get("ASQ_BENCH_SMAX", "512")), args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
