"""Generate from a quantized model on the card: the port of
``examples/test_model.py``, with its flags.

  python -m autosmoothquant_tpu_torch.cli.test_model \
      --quantized-model-path /out/llama-int8 --tokenizer-path /ckpts/llama \
      --prompt "Life is beautiful"
  python -m autosmoothquant_tpu_torch.cli.test_model \
      --quantized-model-path /out/llama-int8 --prompt-ids 1,15043,3186 --tp 2

One prompt through ``Engine.generate`` (max_batch 1). Prints the decoded
prompt and continuation, or with ``--prompt-ids`` the new token ids
space-separated. ``--speculative-gamma N`` decodes a greedy run
speculatively (prompt lookup of ``--speculative-ngram`` tokens; the same
tokens). ``--tp N`` above 1 runs N ranks, one process a card (NCCL), with
the params split over a "model" axis (``shard/``), and rank 0 prints;
``--tp 0`` takes every visible card (one where there is one), as the JAX
CLI takes every device. ``--device cpu --tp N`` runs the N ranks on the CPU
over gloo (the plain versions of the kernels).
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
                   help="tensor-parallel ranks: 0 = every visible card, 1 = one card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain versions (ranks over gloo)")
    return p.parse_args(argv)


def tp_degree(tp: int, device: str, share: bool = False) -> int:
    """The ranks ``--tp`` asks for: 0 takes every visible card (1 on the CPU
    or with one card); more than the visible cards raises ValueError, unless
    ``share`` (ranks may share a card: gloo)."""
    visible = torch.cuda.device_count() if device == "cuda" else 1
    n = tp if tp else max(visible, 1)
    if device == "cuda" and not share and n > max(visible, 1):
        raise ValueError(f"--tp {n}: only {visible} card(s) visible")
    return n


def generate(args, device, compute_dtype, kv_dtype, mesh=None) -> str:
    """The CLI's output line for parsed ``args``; under ``mesh``, this rank's
    run of it (every rank computes every token)."""
    from ..serve.engine import Engine, GenerationConfig
    from . import load

    if args.prompt_ids:
        tok = None
        ids = [int(t) for t in args.prompt_ids.split(",")]
    elif args.tokenizer_path:
        from ..utils.tokenizer import load_tokenizer

        tok = load_tokenizer(args.tokenizer_path)
        ids = list(tok(args.prompt).input_ids)
    else:
        raise SystemExit("--tokenizer-path or --prompt-ids needed")
    model_mod, _, cfg, params, qcfg = load(args.quantized_model_path,
                                           "cpu" if mesh is not None else device)
    if args.kv_dtype == "int8":
        kv_dtype = torch.int8
    eng = Engine(model_mod, params, cfg, qcfg, max_batch=1, max_seq=args.max_seq,
                 kv_dtype=kv_dtype or torch.bfloat16, compute_dtype=compute_dtype,
                 device=device, mesh=mesh)
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
        return tok.decode(ids + out)
    return " ".join(str(t) for t in out)


def _rank(args, device, compute_dtype, kv_dtype, tp) -> str:
    """One rank of ``--tp``: a model axis over every rank, this rank's card."""
    import torch.distributed as dist

    from ..shard.mesh import make_mesh
    from . import rank_devices

    rank = dist.get_rank()
    devices = rank_devices(tp, device)
    if device == "cuda":
        torch.cuda.set_device(rank)
    mesh = make_mesh(data=1, model=tp, devices=devices)
    return generate(args, devices[rank], compute_dtype, kv_dtype, mesh)


def main(argv=None, *, device=None, compute_dtype=torch.bfloat16, kv_dtype=None):
    """Run the CLI; ``device`` (None: ``--device``), ``compute_dtype`` and
    ``kv_dtype`` (None: ``--kv-dtype``'s; int8 always wins) let a caller run
    the plain versions on the CPU."""
    args = parse_args(argv)
    device = device or args.device
    tp = tp_degree(args.tp, torch.device(device).type)
    if tp == 1:
        print(generate(args, device, compute_dtype, kv_dtype))
        return
    from ..shard.mesh import launch

    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    outs = launch(_rank, tp, args, torch.device(device).type, compute_dtype, kv_dtype, tp,
                  backend=backend)
    print(outs[0])


if __name__ == "__main__":
    main()
