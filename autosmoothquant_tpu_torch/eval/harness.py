"""The native evaluation harness (the port of
``autosmoothquant_tpu/eval/harness.py``; the reference's vendored lm-eval
fork, ``benchmarks/evaluator.py:23-651`` simple_evaluate / evaluate and
``benchmarks/utils.py`` make_table). Pure Python over the LM adapter: tasks
are declarative request sets, the harness fans their requests out over
:class:`~.lm_adapter.TorchLM` (sharded over ranks where there are several)
and aggregates them with bootstrap stderr.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lm_adapter import TorchLM, gather_results

# ---------------------------------------------------------------------------
# Per-metric aggregation registry — the analog of the vendored fork's
# metric plumbing (ref: benchmarks/evaluator.py aggregation +
# lm_eval metrics registry): each metric name maps to how per-sample values
# reduce and whether larger is better (used by make_table arrows and any
# model-comparison tooling).
# ---------------------------------------------------------------------------

AGGREGATIONS: Dict[str, Callable[[Sequence[float]], float]] = {
    "mean": lambda v: float(np.mean(v)),
    "sum": lambda v: float(np.sum(v)),
    "perplexity": lambda nll_and_count: float(
        math.exp(sum(x for x, _ in nll_and_count)
                 / max(sum(n for _, n in nll_and_count), 1))),
    "bits_per_token": lambda nll_and_count: float(
        sum(x for x, _ in nll_and_count)
        / max(sum(n for _, n in nll_and_count), 1) / math.log(2)),
}

HIGHER_IS_BETTER: Dict[str, bool] = {
    "acc": True, "acc_norm": True, "exact_match": True,
    "perplexity": False, "bits_per_token": False,
}


def register_metric(name: str, agg: Callable, higher_is_better: bool) -> None:
    """Extend the registry (custom tasks can add f1, bleu, ...)."""
    AGGREGATIONS[name] = agg
    HIGHER_IS_BETTER[name] = higher_is_better


def aggregate_metrics(samples: Dict[str, Sequence],
                      kinds: Dict[str, str],
                      stderr_for: Sequence[str] = ()) -> Dict[str, float]:
    """Reduce per-sample metric values through the registry; appends
    bootstrap stderr columns for the requested mean-like metrics."""
    out = {}
    for metric, values in samples.items():
        out[metric] = AGGREGATIONS[kinds.get(metric, "mean")](values)
        if metric in stderr_for:
            out[f"{metric}_stderr"] = bootstrap_stderr(list(values))
    return out


@dataclasses.dataclass
class MultipleChoiceTask:
    """Each doc: context tokens + N choice continuations + gold index.
    Accuracy = argmax loglikelihood (acc) and length-normalized variant
    (acc_norm), matching lm-eval conventions."""

    REQUEST_TYPE = "loglikelihood"
    VERSION = 0  # task versioning (lm-eval results["versions"] analog)

    name: str
    docs: Sequence[Tuple[Sequence[int], Sequence[Sequence[int]], int]]

    def build_requests(self):
        reqs = []
        index = []
        for di, (ctx, choices, _gold) in enumerate(self.docs):
            for ci, cont in enumerate(choices):
                reqs.append((list(ctx), list(cont)))
                index.append((di, ci))
        return reqs, index

    def aggregate(self, results, index) -> Dict[str, float]:
        per_doc: Dict[int, Dict[int, Tuple[float, int]]] = {}
        for (di, ci), (ll, _greedy) in zip(index, results):
            per_doc.setdefault(di, {})[ci] = ll
        accs, accs_norm = [], []
        for di, (ctx, choices, gold) in enumerate(self.docs):
            lls = [per_doc[di][ci] for ci in range(len(choices))]
            lls_norm = [ll / max(len(c), 1) for ll, c in zip(lls, choices)]
            accs.append(float(int(np.argmax(lls)) == gold))
            accs_norm.append(float(int(np.argmax(lls_norm)) == gold))
        return aggregate_metrics({"acc": accs, "acc_norm": accs_norm},
                                 kinds={}, stderr_for=("acc",))


@dataclasses.dataclass
class GenerateUntilTask:
    """Generation-scored task (the reference's greedy_until request type,
    benchmarks/base.py:greedy_until + evaluator request fan-out). Each doc:
    (context tokens, expected continuation tokens). Metric: exact_match of
    the generated prefix against the expected tokens, after stop-sequence
    truncation."""

    REQUEST_TYPE = "generate_until"
    VERSION = 0

    name: str
    docs: Sequence[Tuple[Sequence[int], Sequence[int]]]
    max_new_tokens: int = 32
    stop_sequences: Optional[Sequence[Sequence[int]]] = None
    eos_token_id: Optional[int] = None

    def build_requests(self):
        reqs = [list(ctx) for ctx, _exp in self.docs]
        index = list(range(len(self.docs)))
        return reqs, index

    def run(self, lm: TorchLM, reqs):
        return lm.generate_until(
            reqs, max_new_tokens=self.max_new_tokens,
            eos_token_id=self.eos_token_id,
            stop_sequences=self.stop_sequences)

    def aggregate(self, results, index) -> Dict[str, float]:
        matches = []
        for di, toks in zip(index, results):
            exp = list(self.docs[di][1])
            matches.append(float(list(toks)[: len(exp)] == exp))
        return aggregate_metrics({"exact_match": matches}, kinds={},
                                 stderr_for=("exact_match",))


@dataclasses.dataclass
class RollingPPLTask:
    """Rolling-perplexity task (the reference's loglikelihood_rolling
    request type, benchmarks/base.py:161-206): each doc is a token stream;
    metrics are token-level perplexity and bits-per-token."""

    REQUEST_TYPE = "loglikelihood_rolling"
    VERSION = 0

    name: str
    docs: Sequence[Sequence[int]]

    def build_requests(self):
        return [list(d) for d in self.docs], list(range(len(self.docs)))

    def run(self, lm: TorchLM, reqs):
        return lm.loglikelihood_rolling(reqs)

    def aggregate(self, results, index) -> Dict[str, float]:
        nll_and_count = [(-float(ll), len(self.docs[di]))
                         for di, ll in zip(index, results)]
        return aggregate_metrics(
            {"perplexity": nll_and_count, "bits_per_token": nll_and_count},
            kinds={"perplexity": "perplexity",
                   "bits_per_token": "bits_per_token"})


def bootstrap_stderr(values: Sequence[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """ref: benchmarks/evaluator.py bootstrap aggregation."""
    if len(values) <= 1:
        return 0.0
    rng = random.Random(seed)
    means = []
    for _ in range(iters):
        sample = [values[rng.randrange(len(values))] for _ in values]
        means.append(sum(sample) / len(sample))
    mu = sum(means) / len(means)
    return math.sqrt(sum((m - mu) ** 2 for m in means) / (len(means) - 1))


def evaluate(lm: TorchLM, tasks: Sequence,
             rank: int = 0, world_size: int = 1, group=None) -> Dict[str, Dict[str, float]]:
    """simple_evaluate analog (ref: evaluator.py:23-46,233+): requests are
    dispatched by each task's REQUEST_TYPE (loglikelihood / generate_until /
    loglikelihood_rolling, mirroring getattr(lm, reqtype) at
    evaluator.py:352) with the multi-rank request-shard + gather structure
    (evaluator.py:335,442-491): rank ``rank`` of ``world_size`` runs every
    ``world_size``-th request, and the results are gathered over ``group``
    (:func:`~.lm_adapter.gather_results`) so every rank aggregates them
    all."""
    results: Dict[str, Dict[str, float]] = {}
    for task in tasks:
        reqs, index = task.build_requests()
        local_ids = [i for i in range(len(reqs)) if i % world_size == rank]
        runner = getattr(task, "run", None)
        if runner is not None:
            local = runner(lm, [reqs[i] for i in local_ids])
        else:
            local = getattr(lm, task.REQUEST_TYPE)([reqs[i] for i in local_ids])
        if world_size > 1:
            flat = gather_results(list(zip(local_ids, local)), world_size, group)
            merged = dict(flat)
            ordered = [merged[i] for i in range(len(reqs))]
        else:
            ordered = local
        results[task.name] = task.aggregate(ordered, index)
    return results


def simple_evaluate(lm: TorchLM, tasks: Sequence, rank: int = 0,
                    world_size: int = 1, group=None) -> Dict[str, Dict]:
    """The reference CLI's entry-point shape (ref: evaluator.py:23-46
    simple_evaluate returns {"results", "versions", "config"}): task
    metrics plus per-task VERSION stamps and the run configuration."""
    results = evaluate(lm, tasks, rank=rank, world_size=world_size, group=group)
    return {
        "results": results,
        "versions": {t.name: getattr(t, "VERSION", 0) for t in tasks},
        "config": {
            "model": type(lm).__name__,
            "model_family": getattr(lm.model, "FAMILY", None),
            "batch_size": lm.batch_size,
            "max_length": lm.max_length,
            "quantized": lm.qcfg is not None,
            "world_size": world_size,
        },
    }


def make_table(results: Dict[str, Dict[str, float]],
               versions: Optional[Dict[str, int]] = None) -> str:
    """ref: benchmarks/utils.py make_table / lm_eval.utils.make_table.
    Accepts either evaluate() output or simple_evaluate() output."""
    if "results" in results and isinstance(results.get("results"), dict) \
            and "versions" in results:
        versions = results.get("versions")
        results = results["results"]
    lines = ["| task | version | metric | value |",
             "|------|---------|--------|-------|"]
    for task, metrics in sorted(results.items()):
        ver = (versions or {}).get(task, "-")
        for metric, value in sorted(metrics.items()):
            lines.append(f"| {task} | {ver} | {metric} | {value:.4f} |")
    return "\n".join(lines)
