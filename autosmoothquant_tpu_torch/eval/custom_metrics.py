"""A worked ``register_metric`` example: token-level F1 for generate tasks
(the port's copy of ``examples/custom_metrics.py``, which registers into
the JAX package's harness).

The native harness scores generation by exact_match
(``harness.py:GenerateUntilTask.aggregate``); custom metrics plug in
through ``register_metric(name, aggregation, higher_is_better)``, the
analog of the reference's vendored lm-eval metric registry. Importing this
module registers SQuAD-style token F1, and ``transform_tasks`` turns
generate tasks into ones that report it beside exact_match. From the CLI:

    python -m autosmoothquant_tpu_torch.cli.eval_model ... \\
        --task-files examples/tasks/stock_gen.jsonl \\
        --metrics-module autosmoothquant_tpu_torch/eval/custom_metrics.py

``eval_model`` imports the file and, since it defines ``transform_tasks``,
applies it to the loaded task list.
"""

from __future__ import annotations

import collections
import dataclasses

from autosmoothquant_tpu_torch.eval.harness import (
    GenerateUntilTask, aggregate_metrics, register_metric)


def _mean(xs):
    return sum(xs) / max(len(xs), 1)


# the whole registry contract: name -> (aggregation, direction)
register_metric("f1", _mean, higher_is_better=True)


def token_f1(pred, gold) -> float:
    """SQuAD-style bag-of-tokens F1 between two token-id sequences."""
    if not pred or not gold:
        return float(pred == gold)
    common = collections.Counter(pred) & collections.Counter(gold)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred)
    recall = overlap / len(gold)
    return 2 * precision * recall / (precision + recall)


@dataclasses.dataclass
class F1GenerateTask(GenerateUntilTask):
    """GenerateUntilTask that also reports token F1 through the registry."""

    def aggregate(self, results, index):
        matches, f1s = [], []
        for di, toks in zip(index, results):
            exp = list(self.docs[di][1])
            got = list(toks)
            matches.append(float(got[: len(exp)] == exp))
            f1s.append(token_f1(got[: len(exp) + 8], exp))
        return aggregate_metrics({"exact_match": matches, "f1": f1s},
                                 kinds={}, stderr_for=("exact_match", "f1"))


def transform_tasks(tasks):
    """The eval_model hook: generate tasks become F1 ones."""
    out = []
    for t in tasks:
        if isinstance(t, GenerateUntilTask):
            out.append(F1GenerateTask(
                name=t.name, docs=t.docs, max_new_tokens=t.max_new_tokens,
                stop_sequences=t.stop_sequences,
                eos_token_id=t.eos_token_id))
        else:
            out.append(t)
    return out
