"""Task loading for the native harness, JSON-lines files to task objects
(the port of ``autosmoothquant_tpu/eval/tasks.py``).

The reference builds its tasks from the vendored lm-eval registry
(benchmarks/evaluator.py:233-335); here tasks load from local JSON-lines
files, and a file's schema selects the task type:

  multiple-choice: {"query": str, "choices": [str, ...], "gold": int}
  generate-until:  {"input": str, "target": str}
  rolling ppl:     {"text": str}

Few-shot contexts follow the lm-eval convention: exemplars rendered as
"<query><gold choice>" joined with "\n\n" and prepended to every scored
query (after an optional task ``description``). Two sampling modes:
  front  - the first k docs are everyone's exemplars and are not scored
  random - every scored doc draws its own k exemplars with a seeded RNG,
           never itself (lm-eval's fewshot_context sampling,
           benchmarks/base.py fewshot_context / rnd.sample)
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .harness import GenerateUntilTask, MultipleChoiceTask, RollingPPLTask


def _read_jsonl(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _render(d) -> str:
    if "choices" in d:
        return f"{d['query']}{d['choices'][d['gold']]}"
    if "target" in d:
        return f"{d['input']}{d['target']}"
    raise ValueError("doc is not few-shot renderable")


def _fewshot_prefix(exemplars, description: str = "") -> str:
    parts = [_render(d) for d in exemplars]
    body = "\n\n".join(parts) + ("\n\n" if parts else "")
    desc = description + "\n\n" if description else ""
    return desc + body


def load_task(path: str, tokenizer, *, num_fewshot: int = 0,
              name: Optional[str] = None, limit: Optional[int] = None,
              max_new_tokens: int = 32, description: str = "",
              fewshot_sample: str = "front", fewshot_seed: int = 1234):
    """Build a harness task from a JSONL file (schema selects the type)."""
    import random

    docs = _read_jsonl(path)
    if not docs:
        raise ValueError(f"{path}: empty task file")
    if fewshot_sample not in ("front", "random"):
        raise ValueError("fewshot_sample must be 'front' or 'random'")
    task_name = name or os.path.splitext(os.path.basename(path))[0]

    def enc(s):
        # continuations are spliced mid-sequence: special tokens (BOS) must
        # not be inserted (the lm_eval_adapter._enc convention); tokenizers
        # without the kwarg (tests' word-level stub) take the plain call
        try:
            return list(tokenizer(s, add_special_tokens=False).input_ids)
        except TypeError:
            return list(tokenizer(s).input_ids)

    if "text" in docs[0]:
        scored = docs if limit is None else docs[:limit]
        return RollingPPLTask(name=task_name,
                              docs=[enc(d["text"]) for d in scored])

    if fewshot_sample == "front":
        scored = docs[num_fewshot:]
        prefixes = [_fewshot_prefix(docs[:num_fewshot], description)] * \
            len(scored)
    else:  # random: per-doc exemplars excluding the doc itself, seeded
        rnd = random.Random(fewshot_seed)
        scored = list(docs)
        prefixes = []
        for i, d in enumerate(scored):
            candidates = docs[:i] + docs[i + 1:]
            k = min(num_fewshot, len(candidates))
            prefixes.append(_fewshot_prefix(rnd.sample(candidates, k),
                                            description))
    if limit is not None:
        scored = scored[:limit]
        prefixes = prefixes[:limit]
    if not scored:
        raise ValueError(f"{path}: no docs left to score after "
                         f"{num_fewshot} few-shot exemplars")

    if "choices" in docs[0]:
        mc = []
        for pre, d in zip(prefixes, scored):
            ctx = enc(pre + d["query"])
            mc.append((ctx, [enc(c) for c in d["choices"]], int(d["gold"])))
        return MultipleChoiceTask(name=task_name, docs=mc)

    if "target" in docs[0]:
        gen = [(enc(pre + d["input"]), enc(d["target"]))
               for pre, d in zip(prefixes, scored)]
        return GenerateUntilTask(name=task_name, docs=gen,
                                 max_new_tokens=max_new_tokens)

    raise ValueError(
        f"{path}: docs need 'choices'+'gold', 'target', or 'text' keys")
