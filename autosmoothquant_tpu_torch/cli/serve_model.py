"""Serve a quantized model over HTTP on the card (continuous batching,
sampling, the OpenAI wire shapes): the port of ``examples/serve_model.py``,
with its flags.

  python -m autosmoothquant_tpu_torch.cli.serve_model \
      --quantized-model-path /out/llama-int8 --tokenizer-path /ckpts/llama \
      --port 8000 [--kv-dtype int8]

  curl -s localhost:8000/generate -d '{"prompt": "Hello", "max_new_tokens": 32}'
  curl -s localhost:8000/v1/completions -d '{"prompt": "Hello", "max_tokens": 32}'

It prints the address it bound (``--port 0`` takes a free port) and serves
until SIGINT, then exits 0. ``--paged`` serves the block-paged engine
(``serve/paged.py:PagedEngine``, ``--block-size`` tokens a page,
``--num-pages`` pages or the contiguous pool's capacity) with its automatic
prefix radix tree (``--no-auto-prefix``: explicit prefixes only).
``--speculative-gamma N`` decodes greedy ticks speculatively (prompt lookup
of ``--speculative-ngram`` tokens, the draft length adaptive unless
``--no-adaptive-gamma``). ``--tp`` above 1 raises NotImplementedError naming
its ROADMAP item (``cli/__init__.py:refuse_unported``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quantized-model-path", required=True)
    p.add_argument("--tokenizer-path", default=None,
                   help="optional; enables text prompts and decoded replies")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8, help="concurrent decode slots")
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--steps-per-sync", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="chunked-prefill admission size (0 = whole prompt)")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel degree: 0 or 1 = one card (above 1 is refused)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speculative-gamma", type=int, default=0,
                   help="speculative draft length (0 = off; greedy requests only)")
    p.add_argument("--speculative-ngram", type=int, default=3)
    p.add_argument("--no-adaptive-gamma", action="store_true")
    p.add_argument("--paged", action="store_true", help="the block-paged KV engine")
    p.add_argument("--block-size", type=int, default=64,
                   help="paged engine page size (tokens)")
    p.add_argument("--num-pages", type=int, default=0,
                   help="paged engine total pages (0 = the contiguous pool's capacity)")
    p.add_argument("--no-auto-prefix", action="store_true",
                   help="the paged engine's automatic prefix sharing off (explicit "
                        "prefixes only)")
    p.add_argument("--model-id", default=None,
                   help="name reported by /v1/models and completion envelopes "
                        "(default: checkpoint directory name)")
    return p.parse_args(argv)


def build(args, *, device="cuda", compute_dtype=torch.bfloat16, kv_dtype=None):
    """(api, httpd, family) from parsed args, without serving; ``device``,
    ``compute_dtype`` and ``kv_dtype`` (None: ``--kv-dtype``'s bf16 or int8;
    int8 always wins) let a caller run the plain versions on the CPU."""
    from ..serve.api import serve
    from ..serve.batching import ContinuousEngine
    from ..serve.paged import PagedEngine
    from . import load, refuse_unported

    refuse_unported(args)
    model_mod, family, cfg, params, qcfg = load(args.quantized_model_path, device)
    tokenizer = None
    if args.tokenizer_path:
        from ..utils.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer_path)
    if args.kv_dtype == "int8":
        kv_dtype = torch.int8
    kw = dict(max_batch=args.max_batch, max_seq=args.max_seq,
              kv_dtype=kv_dtype or torch.bfloat16, compute_dtype=compute_dtype,
              steps_per_sync=args.steps_per_sync, prefill_chunk=args.prefill_chunk or None,
              seed=args.seed, speculative_gamma=args.speculative_gamma,
              speculative_ngram=args.speculative_ngram,
              speculative_adaptive=not args.no_adaptive_gamma, device=device)
    if args.paged:
        eng = PagedEngine(model_mod, params, cfg, qcfg, block_size=args.block_size,
                          num_pages=args.num_pages or None,
                          auto_prefix=not args.no_auto_prefix, **kw)
    else:
        eng = ContinuousEngine(model_mod, params, cfg, qcfg, **kw)
    model_id = (args.model_id or Path(args.quantized_model_path).name
                or "autosmoothquant-tpu")
    api, httpd = serve(eng, host=args.host, port=args.port, tokenizer=tokenizer,
                       model_id=model_id)
    return api, httpd, family


def main(argv=None):
    args = parse_args(argv)
    api, httpd, family = build(args)
    print(f"[serve_model] {family} on {httpd.server_address[0]}:"
          f"{httpd.server_address[1]} (slots={args.max_batch}, "
          f"max_seq={args.max_seq})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        api.stop()
        httpd.server_close()


if __name__ == "__main__":
    main()
