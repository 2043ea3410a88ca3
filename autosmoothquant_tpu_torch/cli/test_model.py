"""Generate from a quantized model on the card: the port of
``examples/test_model.py``, with its flags.

  python -m autosmoothquant_tpu_torch.cli.test_model \
      --quantized-model-path /out/llama-int8 --tokenizer-path /ckpts/llama \
      --prompt "Life is beautiful"
  python -m autosmoothquant_tpu_torch.cli.test_model \
      --quantized-model-path /out/llama-int8 --prompt-ids 1,15043,3186

One prompt through ``Engine.generate`` (max_batch 1). Prints the decoded
prompt and continuation, or with ``--prompt-ids`` the new token ids
space-separated. ``--speculative-gamma N`` decodes a greedy run
speculatively (prompt lookup of ``--speculative-ngram`` tokens; the same
tokens). ``--tp`` above 1 raises NotImplementedError naming its ROADMAP
item.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quantized-model-path", required=True)
    p.add_argument("--tokenizer-path", default=None,
                   help="required unless --prompt-ids is given")
    p.add_argument("--prompt", default="Life is beautiful")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids; skips the tokenizer")
    p.add_argument("--max-new-tokens", type=int, default=20)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples (with --top-k/--top-p)")
    p.add_argument("--top-k", type=int, default=0, help="0 = off")
    p.add_argument("--top-p", type=float, default=1.0, help="1 = off")
    p.add_argument("--repetition-penalty", type=float, default=1.0,
                   help="1 = off (HF convention)")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--speculative-gamma", type=int, default=0,
                   help="speculative draft length (0 = off; greedy only)")
    p.add_argument("--speculative-ngram", type=int, default=3)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                   help="int8 selects the quantized KV cache")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel degree: 0 or 1 = one card (above 1 is refused)")
    return p.parse_args(argv)


def main(argv=None, *, device="cuda", compute_dtype=torch.bfloat16, kv_dtype=None):
    """Run the CLI; ``device``, ``compute_dtype`` and ``kv_dtype`` (None:
    ``--kv-dtype``'s; int8 always wins) let a caller run the plain versions
    on the CPU."""
    from ..serve.engine import Engine, GenerationConfig
    from . import load, refuse_unported

    args = parse_args(argv)
    refuse_unported(args)
    if args.prompt_ids:
        tok = None
        ids = [int(t) for t in args.prompt_ids.split(",")]
    elif args.tokenizer_path:
        from ..utils.tokenizer import load_tokenizer

        tok = load_tokenizer(args.tokenizer_path)
        ids = list(tok(args.prompt).input_ids)
    else:
        raise SystemExit("--tokenizer-path or --prompt-ids needed")
    model_mod, _, cfg, params, qcfg = load(args.quantized_model_path, device)
    if args.kv_dtype == "int8":
        kv_dtype = torch.int8
    eng = Engine(model_mod, params, cfg, qcfg, max_batch=1, max_seq=args.max_seq,
                 kv_dtype=kv_dtype or torch.bfloat16, compute_dtype=compute_dtype,
                 device=device)
    out = eng.generate(
        [ids],
        GenerationConfig(max_new_tokens=args.max_new_tokens,
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p, repetition_penalty=args.repetition_penalty,
                         eos_token_id=tok.eos_token_id if tok is not None else None,
                         speculative_gamma=args.speculative_gamma,
                         speculative_ngram=args.speculative_ngram),
        seed=args.seed)[0]
    if tok is not None:
        print(tok.decode(ids + out))
    else:
        print(" ".join(str(t) for t in out))


if __name__ == "__main__":
    main()
