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
downloads nothing. ``--stages`` and ``--tensor-parallel`` above 1 raise
NotImplementedError naming their ROADMAP item.

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
                   help="pipeline stages for perplexity: 0 or 1 = one card (above 1 "
                        "is refused)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches a window batch (with --stages)")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="tensor-parallel ways: 0 or 1 = one card (above 1 is refused)")
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


def main(argv=None, *, device="cuda"):
    """Run the CLI on ``device`` (the card unless the caller asks for the
    CPU); returns the results it printed."""
    from ..eval.ppl import perplexity_from_tokens
    from ..runtime import resolve_device
    from ..utils.profiling import phase_report
    from ..utils.tokenizer import load_tokenizer
    from . import refuse_unported

    args = parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(device)
    phase_report(reset=True)   # the report holds this run's stages alone
    stages = _Stages(dev)
    t0 = time.perf_counter()
    with stages("load"):
        model_mod, cfg, params, qcfg = load_model(args, dev)
    with stages("tokenizer"):
        tokenizer = load_tokenizer(args.tokenizer_path)
    results = {}
    report = {"device": str(dev)}

    if args.eval_ppl:
        with stages("dataset"):
            stream = ppl_stream(args, tokenizer)
        with stages("ppl"):
            ppl = perplexity_from_tokens(
                model_mod, params, cfg, stream, max_length=args.max_length, qcfg=qcfg,
                compute_dtype=torch.bfloat16, progress=True,
                batch_windows=args.batch_windows, device=dev)
        scored = (len(stream) // args.max_length) * args.max_length
        report["ppl_tokens"] = scored
        results[args.dataset] = {"ppl": ppl}
        print({"results": results})

    lm = None
    if args.task_files:
        from ..eval.harness import evaluate, make_table
        from ..eval.lm_adapter import TorchLM
        from ..eval.tasks import load_task

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
            res = evaluate(lm, native_tasks)
        results.update(res)
        print(make_table(res))
        report["engines_built"] = lm.engines_built
        report["graphs_captured"] = len(lm.engine.graphs) if lm.engine is not None else 0

    if args.tasks and args.tasks != "wikitext2":
        from ..eval.lm_eval_adapter import run_lm_eval

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


if __name__ == "__main__":
    main()
