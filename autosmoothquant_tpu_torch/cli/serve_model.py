"""Serve a quantized model over HTTP on the card (continuous batching,
sampling, the OpenAI wire shapes): the port of ``examples/serve_model.py``,
with its flags.

  python -m autosmoothquant_tpu_torch.cli.serve_model \
      --quantized-model-path /out/llama-int8 --tokenizer-path /ckpts/llama \
      --port 8000 [--kv-dtype int8] [--tp 2]

  curl -s localhost:8000/generate -d '{"prompt": "Hello", "max_new_tokens": 32}'
  curl -s localhost:8000/v1/completions -d '{"prompt": "Hello", "max_tokens": 32}'

It prints the address it bound (``--port 0`` takes a free port) and serves
until SIGINT, then exits 0. ``--paged`` serves the block-paged engine
(``serve/paged.py:PagedEngine``, ``--block-size`` tokens a page,
``--num-pages`` pages or the contiguous pool's capacity) with its automatic
prefix radix tree (``--no-auto-prefix``: explicit prefixes only).
``--speculative-gamma N`` decodes greedy ticks speculatively (prompt lookup
of ``--speculative-ngram`` tokens, the draft length adaptive unless
``--no-adaptive-gamma``).

``--tp N`` above 1 serves over N ranks, one process a rank, with the params
split over a "model" axis (``shard/``); every flag above composes with it.
This process is rank 0: it starts ranks 1 .. N-1 (spawned), binds the port
and runs the scheduler, and the other ranks apply its scheduler's turns tick
by tick (``serve/api.py:follow``). NCCL takes a card a rank, and more ranks
than visible cards raise ValueError; ``--backend gloo`` lets ranks share a
card and decodes eagerly (a gloo collective cannot be captured in a CUDA
graph); ``--device cpu`` runs the ranks on the CPU over gloo (the plain
versions of the kernels). ``--tp 0`` takes every visible card (one where
there is one), as the JAX CLI takes every device. A rank that dies or
raises stops the server as a lost device does: /health answers 503 and
every request fails with the error's text. SIGINT ends every rank.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
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
                   help="tensor-parallel ranks, a process each: 0 = every visible card, "
                        "1 = one card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain versions (ranks over gloo)")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="the ranks' process group on the card: nccl takes one card a "
                        "rank, gloo lets ranks share one (eager decode; the CPU always "
                        "takes gloo)")
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


def make_engine(args, *, device, compute_dtype, kv_dtype=None, mesh=None):
    """(engine, family) of parsed args on ``device``: under ``mesh``, this
    rank's share of it (the params split as ``shard/`` splits them; eager on
    a gloo mesh, whose collectives a CUDA graph cannot capture)."""
    from ..serve.batching import ContinuousEngine
    from ..serve.paged import PagedEngine
    from . import load

    model_mod, family, cfg, params, qcfg = load(args.quantized_model_path,
                                                "cpu" if mesh is not None else device)
    if args.kv_dtype == "int8":
        kv_dtype = torch.int8
    kw = dict(max_batch=args.max_batch, max_seq=args.max_seq,
              kv_dtype=kv_dtype or torch.bfloat16, compute_dtype=compute_dtype,
              steps_per_sync=args.steps_per_sync, prefill_chunk=args.prefill_chunk or None,
              seed=args.seed, speculative_gamma=args.speculative_gamma,
              speculative_ngram=args.speculative_ngram,
              speculative_adaptive=not args.no_adaptive_gamma, device=device, mesh=mesh)
    if mesh is not None and mesh.backend == "gloo":
        kw["cuda_graph"] = False
    if args.paged:
        eng = PagedEngine(model_mod, params, cfg, qcfg, block_size=args.block_size,
                          num_pages=args.num_pages or None,
                          auto_prefix=not args.no_auto_prefix, **kw)
    else:
        eng = ContinuousEngine(model_mod, params, cfg, qcfg, **kw)
    return eng, family


def build(args, *, device="cuda", compute_dtype=torch.bfloat16, kv_dtype=None, mesh=None,
          on_finish=None):
    """(api, httpd, family) from parsed args, without serving; ``device``,
    ``compute_dtype`` and ``kv_dtype`` (None: ``--kv-dtype``'s bf16 or int8;
    int8 always wins) let a caller run the plain versions on the CPU. Under
    ``mesh`` this is rank 0's server. ``on_finish(engine)``, where given,
    returns the server's ``on_finish(uid, request)`` hook
    (``serve/api.py:ServingAPI``)."""
    from ..serve.api import serve

    eng, family = make_engine(args, device=device, compute_dtype=compute_dtype,
                              kv_dtype=kv_dtype, mesh=mesh)
    tokenizer = None
    if args.tokenizer_path:
        from ..utils.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer_path)
    model_id = (args.model_id or Path(args.quantized_model_path).name
                or "autosmoothquant-tpu")
    api, httpd = serve(eng, host=args.host, port=args.port, tokenizer=tokenizer,
                       model_id=model_id, on_finish=on_finish and on_finish(eng))
    return api, httpd, family


def join_mesh(rank, world, port, backend, device_type, timeout=None):
    """This rank's model=``world`` mesh, the process group joined at
    localhost:``port``."""
    from ..shard.mesh import init_distributed, make_mesh
    from . import rank_devices

    init_distributed(f"127.0.0.1:{port}", world, rank, backend, timeout)
    devices = rank_devices(world, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(torch.device(devices[rank]))
    return make_mesh(data=1, model=world, devices=devices)


def _follower(args, rank, world, port, backend, device_type, compute_dtype, kv_dtype,
              threads, timeout, on_finish):
    """Rank ``rank`` of ``--tp``: its engine, following rank 0's plans until
    rank 0 stops (an exception ends the process, non-zero)."""
    import torch.distributed as dist

    from ..serve.api import follow

    signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0 ends this rank
    torch.set_num_threads(threads)
    mesh = join_mesh(rank, world, port, backend, device_type, timeout)
    eng, _ = make_engine(args, device=mesh.device, compute_dtype=compute_dtype,
                         kv_dtype=kv_dtype, mesh=mesh)
    follow(eng, on_finish=on_finish and on_finish(eng))
    dist.destroy_process_group()


def _end(procs, wait: float = 0.0) -> None:
    """Wait up to ``wait`` seconds for the rank processes, then kill those
    still running."""
    deadline = time.monotonic() + wait
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def _watch(procs, state) -> None:
    """Rank 0's watch over the other ranks' processes: one that ends while
    the server starts aborts it (exit 1); one that ends while it serves
    loses the server (``ServingAPI.lose``); once the server is lost, the
    ranks left can no longer be in step with it, and are ended."""
    while not state["stopping"]:
        api = state["api"]
        dead = [(r, p.exitcode) for r, p in enumerate(procs, 1) if p.exitcode is not None]
        if dead and not state["stopping"]:
            msg = f"rank {dead[0][0]} of {len(procs) + 1} exited with code {dead[0][1]}"
            if api is None:
                print(f"[serve_model] {msg} before the server started", file=sys.stderr,
                      flush=True)
                _end(procs)
                os._exit(1)
            api.lose(msg)
        if api is not None and api.fatal is not None:
            _end(procs)
            return
        time.sleep(0.2)


def serve_ranks(args, world, device_type, compute_dtype=torch.bfloat16, kv_dtype=None,
                on_finish=None, group_timeout=None):
    """``--tp`` above 1: ranks 1 .. world-1 in processes of their own, this
    process rank 0 and the server, until SIGINT."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from ..shard.mesh import free_port

    backend = "gloo" if device_type == "cpu" else args.backend
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follower, daemon=True,
                         args=(args, r, world, port, backend, device_type, compute_dtype,
                               kv_dtype, torch.get_num_threads(), group_timeout, on_finish))
             for r in range(1, world)]
    for p in procs:
        p.start()
    state = {"api": None, "stopping": False}
    threading.Thread(target=_watch, args=(procs, state), daemon=True).start()
    api = httpd = None
    try:
        mesh = join_mesh(0, world, port, backend, device_type)
        api, httpd, family = build(args, device=mesh.device, compute_dtype=compute_dtype,
                                   kv_dtype=kv_dtype, mesh=mesh, on_finish=on_finish)
        state["api"] = api
        print(f"[serve_model] {family} on {httpd.server_address[0]}:"
              f"{httpd.server_address[1]} (slots={args.max_batch}, "
              f"max_seq={args.max_seq})", flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        state["stopping"] = True
        if api is not None:
            api.stop()  # sends the stop plan: every follower returns
        if httpd is not None:
            httpd.server_close()
        _end(procs, wait=30.0 if api is not None and api.fatal is None else 0.0)
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None, *, device=None, compute_dtype=torch.bfloat16, kv_dtype=None,
         on_finish=None, group_timeout=None):
    """Run the CLI; ``device`` (None: ``--device``), ``compute_dtype`` and
    ``kv_dtype`` (None: ``--kv-dtype``'s; int8 always wins) let a caller run
    the plain versions on the CPU. ``on_finish(engine)``, where given, runs
    on every rank once its engine is built and returns that rank's
    ``on_finish(uid, request)`` hook (``serve/api.py``); it must pickle,
    since it reaches the spawned ranks. ``group_timeout`` (seconds) is the
    process group's timeout on the ranks other than 0, the longest they wait
    for rank 0's next plan (None: torch's default)."""
    from .test_model import tp_degree

    args = parse_args(argv)
    device_type = torch.device(device or args.device).type
    # 0 takes every visible card; under NCCL more ranks than cards raise
    world = tp_degree(args.tp, device_type, share=args.backend == "gloo")
    if world > 1:
        serve_ranks(args, world, device_type, compute_dtype, kv_dtype, on_finish,
                    group_timeout)
        return
    api, httpd, family = build(args, device=device or args.device,
                               compute_dtype=compute_dtype, kv_dtype=kv_dtype,
                               on_finish=on_finish)
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
