"""Score a quantized (or float) model on the card: perplexity, the native
harness's JSON-lines tasks and lm-eval tasks; the port of
``examples/eval_model.py`` (the reference's ``examples/eval_model.py:25-138``)
with its flags.

  python -m autosmoothquant_tpu_torch.cli.eval_model \\
      --model-path /out/llama-smoothquant-int8 --tokenizer-path /ckpts/llama \\
      --eval-ppl --dataset-path heldout.jsonl --max-length 2048 --batch-windows 4 \\
      --task-files examples/tasks/stock_mc.jsonl,examples/tasks/stock_gen.jsonl

``--model-path`` is an artifact ``load_any_quantized`` reads, or with
``--origin-model`` an HF float checkpoint (read in f32 by
``convert/hf.py:load_hf_params``). Perplexity computes in bf16, as the JAX
CLI's; the native harness (``--task-files``) and the lm-eval bridge
(``--tasks``) in the LM's f32. ``--dataset-path`` is a local JSON-lines file
of ``{"text": ...}`` records; ``--dataset`` names a loader of
``utils/datautils.py``, which reads local copies under ``--data-dir`` and
downloads nothing.

``--stages N --tensor-parallel M`` (either above 1; JAX
``examples/eval_model.py:48-54,110-124``) runs N x M ranks, one process
each (``shard/mesh.py:launch``), on the mesh ``make_mesh(stage=N,
model=M)``: one card a rank over NCCL, or with ``--backend gloo`` ranks that
may share a card (the CPU always takes gloo). Perplexity runs the
microbatched pipeline over the stages (``--microbatches`` a window batch,
each rank holding its stage's layers, tensor-parallel inside a stage); the
native harness spreads its requests over every rank, each scoring its share
with the whole model, and gathers them (``eval/harness.py:evaluate``); the
lm-eval bridge runs on rank 0. Rank 0 prints, as one card does.

Standard output is the JAX CLI's: the perplexity results, the harness's
table, the lm-eval results. Each stage's wall time (the device synchronized
at its end) goes to standard error, and its last line is one JSON object:
the stage times, the perplexity pass's scored tokens and tokens/s, each
stage's kernel launches, the engines the harness built and their captured
decode graphs, and the results at full precision.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True,
                   help="quantized checkpoint dir, or HF dir with --origin-model")
    p.add_argument("--tokenizer-path", required=True)
    p.add_argument("--origin-model", action="store_true",
                   help="evaluate the float model from an HF checkpoint instead")
    p.add_argument("--eval-ppl", action="store_true")
    p.add_argument("--max-length", type=int, default=2048)
    p.add_argument("--tasks", default="",
                   help="comma-separated lm-eval task names (needs lm_eval)")
    p.add_argument("--task-files", default="",
                   help="comma-separated JSONL task files for the native harness "
                        "(the schema selects multiple-choice / generate / rolling ppl)")
    p.add_argument("--num-fewshot", type=int, default=0)
    p.add_argument("--fewshot-sample", default="front", choices=("front", "random"),
                   help="front: the first k docs are everyone's exemplars; random: "
                        "per-doc seeded exemplar draws (lm-eval's fewshot_context)")
    p.add_argument("--metrics-module", default="",
                   help="python file imported before the tasks run (e.g. "
                        "autosmoothquant_tpu_torch/eval/custom_metrics.py): its "
                        "register_metric calls run, and its transform_tasks(tasks), "
                        "if defined, rewrites the loaded task list")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--batch-windows", type=int, default=1,
                   help="perplexity windows a forward")
    p.add_argument("--stages", type=int, default=0,
                   help="pipeline stages for perplexity (0 or 1 = one stage); the layer "
                        "stack runs the microbatched GPipe schedule")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches a window batch (with a mesh)")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="tensor-parallel ranks inside each stage (0 or 1 = one)")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                   help="the ranks' process group on the card: nccl takes one card a "
                        "rank, gloo lets ranks share one (the CPU always takes gloo)")
    p.add_argument("--dataset", default="wikitext2",
                   help="wikitext2 | ptb | ptb_new | c4 | c4_new | pile | mix")
    p.add_argument("--dataset-path", default=None,
                   help="local jsonl with a 'text' field: perplexity of its records "
                        "joined with blank lines")
    p.add_argument("--pile-path", default=None,
                   help="local pile val .jsonl for --dataset pile")
    p.add_argument("--data-dir", default="data",
                   help="local copies of the datasets --dataset names "
                        "(utils/datautils.py gives the layout)")
    return p.parse_args(argv)


class _Stages:
    """Wall time of each stage (the device synchronized at its start and
    end, through ``utils/profiling.py:phase``) and its kernel launches;
    ``stages(name)`` is a context manager around one stage."""

    def __init__(self, device):
        from ..kernels.counters import launch_counters

        self.device = device
        self.counters = launch_counters()
        self.launches = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name):
        from ..kernels.counters import read_counts
        from ..utils.profiling import phase

        self._sync()
        before = read_counts(self.counters)
        with phase(name):
            yield
            self._sync()
        after = read_counts(self.counters)
        self.launches[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}


def load_model(args, dev):
    """(family module, config, params on ``dev``, QuantConfig or None)."""
    from ..models.registry import get_model_family

    if args.origin_model:
        from ..convert.hf import hf_config_dict, load_hf_params

        config = hf_config_dict(args.model_path)
        model_mod = get_model_family(config)
        cfg = model_mod.config_from_hf(config)
        params = load_hf_params(args.model_path, model_mod.__name__.rsplit(".", 1)[-1],
                                cfg.num_hidden_layers, device=dev)
        return model_mod, cfg, params, None
    from . import load

    model_mod, _, cfg, params, qcfg = load(args.model_path, dev)
    return model_mod, cfg, params, qcfg


def ppl_stream(args, tokenizer):
    """The perplexity pass's token stream: --dataset-path's records, or the
    test split of the loader --dataset names."""
    from ..utils import datautils

    if args.dataset_path:
        return datautils.load_json_text(args.dataset_path, tokenizer)
    if args.dataset == "wikitext2":
        return datautils.load_wikitext2(tokenizer, "test", args.data_dir)
    if args.dataset == "ptb":
        return datautils.load_ptb(tokenizer, "test", args.data_dir)
    _, stream = datautils.get_loaders(args.dataset, tokenizer, nsamples=1,
                                      seqlen=args.max_length, pile_path=args.pile_path,
                                      data_dir=args.data_dir)
    if stream is None:
        raise ValueError(f"dataset {args.dataset!r} has no eval split")
    return stream


def load_metrics_module(path: str):
    spec = importlib.util.spec_from_file_location("asq_custom_metrics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to(params, dev):
    from ..convert.from_jax import _map

    return _map(lambda t: t.to(dev), params)


def _stage_shard(model_mod, cfg, qcfg, params, mesh, dev):
    """This rank's shard of ``params`` on ``dev`` (its stage's layers, split
    over "model" inside the stage)."""
    from ..shard.sharding import param_specs, shard_params, tp_plan, with_stage_axis

    specs = with_stage_axis(param_specs(model_mod.FAMILY, cfg, mesh), mesh,
                            cfg.num_hidden_layers)
    return _to(shard_params(params, mesh, specs, tp_plan(model_mod.FAMILY, cfg, mesh, qcfg)),
               dev)


def run(args, dev, mesh=None):
    """The CLI's work on ``dev`` for parsed ``args``, as one rank of ``mesh``
    where there is one; returns the results it printed."""
    from ..eval.ppl import perplexity_from_tokens
    from ..utils.profiling import phase_report
    from ..utils.tokenizer import load_tokenizer

    phase_report(reset=True)   # the report holds this run's stages alone
    stages = _Stages(dev)
    t0 = time.perf_counter()
    with stages("load"):
        # under a mesh a rank reads the whole model to the host, then keeps
        # what each pass needs on its device
        model_mod, cfg, params, qcfg = load_model(args, "cpu" if mesh else dev)
    with stages("tokenizer"):
        tokenizer = load_tokenizer(args.tokenizer_path)
    results = {}
    report = {"device": str(dev)}
    if mesh is not None:
        report["mesh"] = mesh.shape

    if args.eval_ppl:
        with stages("dataset"):
            stream = ppl_stream(args, tokenizer)
        with stages("ppl"):
            pp = (_stage_shard(model_mod, cfg, qcfg, params, mesh, dev) if mesh is not None
                  else params)
            ppl = perplexity_from_tokens(
                model_mod, pp, cfg, stream, max_length=args.max_length, qcfg=qcfg,
                compute_dtype=torch.bfloat16, progress=True,
                batch_windows=args.batch_windows, mesh=mesh,
                microbatches=args.microbatches, device=dev)
            del pp
        scored = (len(stream) // args.max_length) * args.max_length
        report["ppl_tokens"] = scored
        results[args.dataset] = {"ppl": ppl}
        print({"results": results})

    lm = None
    if args.task_files:
        from ..eval.harness import evaluate, make_table
        from ..eval.lm_adapter import TorchLM
        from ..eval.tasks import load_task

        if mesh is not None:
            params = _to(params, dev)
        lm = TorchLM(model_mod, params, cfg, qcfg, batch_size=args.batch_size,
                     max_length=args.max_length, device=dev)
        native_tasks = [load_task(p, tokenizer, num_fewshot=args.num_fewshot,
                                  fewshot_sample=args.fewshot_sample)
                        for p in (x.strip() for x in args.task_files.split(",")) if p]
        if args.metrics_module:
            mod = load_metrics_module(args.metrics_module)
            if hasattr(mod, "transform_tasks"):
                native_tasks = mod.transform_tasks(native_tasks)
        with stages("tasks"):
            if mesh is None:
                res = evaluate(lm, native_tasks)
            else:
                res = evaluate(lm, native_tasks, rank=mesh.rank, world_size=mesh.size,
                               group=mesh.host_group)
        results.update(res)
        print(make_table(res))
        report["engines_built"] = lm.engines_built
        report["graphs_captured"] = len(lm.engine.graphs) if lm.engine is not None else 0

    if args.tasks and args.tasks != "wikitext2" and (mesh is None or mesh.rank == 0):
        from ..eval.lm_eval_adapter import run_lm_eval

        if mesh is not None:
            params = _to(params, dev)

        with stages("lm_eval"):
            results.update(run_lm_eval(
                model_mod, params, cfg, qcfg, tokenizer,
                tasks=args.tasks.split(","), num_fewshot=args.num_fewshot,
                batch_size=args.batch_size, max_length=args.max_length, device=dev))
        print(results)

    times = phase_report(reset=True)
    report["stages_s"] = {k: v["seconds"] for k, v in times.items()}
    report["wall_s"] = round(time.perf_counter() - t0, 4)
    if "ppl" in report["stages_s"]:
        report["ppl_tokens_per_s"] = report["ppl_tokens"] / max(report["stages_s"]["ppl"], 1e-9)
    report["launches"] = stages.launches
    report["results"] = results
    for name, s in report["stages_s"].items():
        print(f"[eval_model] {name}: {s:.2f} s", file=sys.stderr)
    print(json.dumps({"eval_model": report}, default=str), file=sys.stderr, flush=True)
    return results


def _rank(args, device_type, world):
    """One rank of ``--stages`` x ``--tensor-parallel``: (its standard
    output, its standard error, its results); the parent prints rank 0's."""
    import io

    import torch.distributed as dist

    from ..shard.mesh import make_mesh

    rank = dist.get_rank()
    if device_type == "cpu":
        devices = ["cpu"] * world
    else:
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(world)]
        torch.cuda.set_device(torch.device(devices[rank]))
    mesh = make_mesh(model=args.tensor_parallel or None,
                     stage=args.stages if args.stages > 1 else None, devices=devices)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        results = run(args, torch.device(devices[rank]), mesh)
    return out.getvalue(), err.getvalue(), results


def main(argv=None, *, device="cuda"):
    """Run the CLI on ``device`` (the card unless the caller asks for the
    CPU); returns the results it printed."""
    from ..runtime import resolve_device
    from . import refuse_unported

    args = parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(device)
    world = max(args.stages, 1) * max(args.tensor_parallel, 1)
    if world == 1:
        return run(args, dev)
    from ..shard.mesh import launch

    backend = "gloo" if dev.type == "cpu" else args.backend
    if dev.type == "cuda" and backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards; "
                         f"{torch.cuda.device_count()} visible (--backend gloo shares them)")
    outs = launch(_rank, world, args, dev.type, world, backend=backend,
                  threads=1 if dev.type == "cpu" else None)
    out, err, results = outs[0]
    sys.stdout.write(out)
    sys.stderr.write(err)
    sys.stderr.flush()
    return results


if __name__ == "__main__":
    main()
