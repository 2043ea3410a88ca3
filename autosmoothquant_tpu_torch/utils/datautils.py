"""Calibration token streams (the port's copy of the calibration half of
``autosmoothquant_tpu/utils/datautils.py``).

``random_windows`` and ``synthetic_stream`` are numpy and Python ``random``
code, copied so the port samples the same windows from the same stream and
seed. ``load_json_text`` reads the reference's calibration format (a JSON
lines file with one ``{"text": ...}`` record a line) with the ``json`` module:
the JAX package reads it through ``datasets.load_dataset("json")``, which the
card's machine does not have. The records are joined in file order with
"\\n\\n" and tokenized once, as there.

The evaluation loaders (wikitext2, ptb, c4, pile, ``get_loaders``) are not
ported yet (ROADMAP Queue 1, item 15).
"""

from __future__ import annotations

import json
import random

import numpy as np


def random_windows(tokens: np.ndarray, nsamples: int, seqlen: int,
                   seed: int) -> np.ndarray:
    """int32 [nsamples, seqlen]: windows at ``random.Random(seed)`` starts
    of a token stream (the reference's sampling pattern)."""
    rng = random.Random(seed)
    tokens = np.asarray(tokens).reshape(-1)
    out = np.empty((nsamples, seqlen), np.int32)
    for i in range(nsamples):
        s = rng.randint(0, tokens.size - seqlen - 1)
        out[i] = tokens[s:s + seqlen]
    return out


def read_json_lines(path: str, text_key: str = "text"):
    """The ``text_key`` field of every record of a JSON lines file, in file
    order (blank lines skipped)."""
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line)[text_key] for line in f if line.strip()]


def load_json_text(path: str, tokenizer, text_key: str = "text") -> np.ndarray:
    """int32 token stream of a local JSON lines dataset: its records joined
    with "\\n\\n", tokenized once."""
    text = "\n\n".join(read_json_lines(path, text_key))
    return np.asarray(tokenizer(text).input_ids, np.int32)


def synthetic_stream(vocab_size: int, length: int, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic token stream with mild structure (repeated
    n-grams of a random base) for offline tests and benchmarks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab_size, size=max(length // 4, 16))
    out = np.empty(length, np.int64)
    i = 0
    while i < length:
        s = rng.integers(0, base.size - 8)
        ln = int(rng.integers(4, 9))
        ln = min(ln, length - i)
        out[i:i + ln] = base[s:s + ln]
        i += ln
    return out.astype(np.int32)
