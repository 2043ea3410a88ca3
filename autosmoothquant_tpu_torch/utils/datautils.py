"""Calibration and evaluation token streams (the port's copy of
``autosmoothquant_tpu/utils/datautils.py``).

``random_windows``, ``sample_doc_windows`` and ``synthetic_stream`` are numpy
and Python ``random`` code, copied so the port samples the same windows from
the same stream and seed. The loaders read the records the JAX package reads
through ``datasets.load_dataset``, which the card's machine does not have,
from local files instead, and join and tokenize them as it does:

  - ``load_json_text``: the reference's calibration format, a JSON lines file
    with one ``{"text": ...}`` record a line, joined with "\\n\\n";
  - ``load_wikitext2`` / ``load_ptb``: a JSON lines export of the split,
    ``<data_dir>/wikitext2/<split>.jsonl`` (``text``, joined with "\\n\\n")
    and ``<data_dir>/ptb/<split>.jsonl`` (``sentence``, joined with " "), one
    record a line in the dataset's order;
  - ``load_c4``: the ``json.gz`` shards allenai/c4 publishes,
    ``<data_dir>/c4/c4-train.00000-of-01024.json.gz`` and
    ``<data_dir>/c4/c4-validation.00000-of-00008.json.gz``, read with
    ``gzip`` and ``json``;
  - ``load_pile``: a local pile ``.jsonl`` (a ``.zst`` dump must be
    decompressed first: the card's machine has no ``zstandard``).

A file that is missing raises FileNotFoundError naming the path looked for.
Nothing is downloaded.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from typing import List, Optional, Tuple

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


def read_json_lines(path: str, text_key: str = "text") -> List[str]:
    """The ``text_key`` field of every record of a JSON lines file, in file
    order (blank lines skipped); a ``.gz`` file is read through gzip."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
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


# where the loaders look for local copies of the evaluation datasets
DATA_DIR = "data"
C4_TRAIN = "c4-train.00000-of-01024.json.gz"
C4_VALIDATION = "c4-validation.00000-of-00008.json.gz"


def _require(path: str, what: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what}: no file at {path} (the port reads a local copy and downloads "
            "nothing; see utils/datautils.py for the layout)")
    return path


def _tokens(tokenizer, text: str) -> np.ndarray:
    return np.asarray(tokenizer(text).input_ids, np.int32)


def load_wikitext2(tokenizer, split: str = "test", data_dir: str = DATA_DIR) -> np.ndarray:
    """wikitext-2-raw-v1's ``split``: its records joined with "\\n\\n", then
    tokenized once (the reference's datautils.py:37-55)."""
    path = _require(os.path.join(data_dir, "wikitext2", f"{split}.jsonl"),
                    f"wikitext2 {split}")
    return _tokens(tokenizer, "\n\n".join(read_json_lines(path, "text")))


def load_ptb(tokenizer, split: str = "test", data_dir: str = DATA_DIR) -> np.ndarray:
    """penn_treebank's ``split``: its sentences joined with " ", then
    tokenized once."""
    path = _require(os.path.join(data_dir, "ptb", f"{split}.jsonl"), f"ptb {split}")
    return _tokens(tokenizer, " ".join(read_json_lines(path, "sentence")))


def sample_doc_windows(docs, tokenizer, nsamples: int, seqlen: int,
                       seed: int) -> np.ndarray:
    """Per-document window sampling (the reference's c4 recipe,
    datautils.py:82-110): draw a random document until one tokenizes to at
    least seqlen + 1 tokens, then take one random window of it, so no window
    straddles two documents."""
    rng = random.Random(seed)
    docs = list(docs)
    out = np.empty((nsamples, seqlen), np.int32)
    for n in range(nsamples):
        for _ in range(10_000):
            i = rng.randint(0, len(docs) - 1)
            ids = _tokens(tokenizer, docs[i])
            if ids.size >= seqlen + 1:
                break
        else:
            raise ValueError(f"no document tokenizes to >= {seqlen + 1} tokens")
        s = rng.randint(0, ids.size - seqlen - 1)
        out[n] = ids[s:s + seqlen]
    return out


def load_c4(tokenizer, nsamples: int, seqlen: int, seed: int, data_dir: str = DATA_DIR):
    """(train windows [nsamples, seqlen], validation stream): windows drawn
    per document from the first train shard, and the first 1100 validation
    documents joined with " ", tokenized and capped at 256 * seqlen tokens
    (the reference's get_c4 / get_c4_new)."""
    train = read_json_lines(_require(os.path.join(data_dir, "c4", C4_TRAIN), "c4 train"), "text")
    val = read_json_lines(_require(os.path.join(data_dir, "c4", C4_VALIDATION),
                                 "c4 validation"), "text")
    windows = sample_doc_windows(train, tokenizer, nsamples, seqlen, seed)
    return windows, _tokens(tokenizer, " ".join(val[:1100]))[: 256 * seqlen]


def load_pile(tokenizer, path: str, max_docs: int = 1000) -> np.ndarray:
    """The first ``max_docs`` records of a local pile validation ``.jsonl``
    joined with "\\n\\n", tokenized once (the reference's get_pile reads a
    cluster path; here the caller names the file)."""
    if path.endswith(".zst"):
        raise ValueError(f"{path}: a zstd-compressed pile dump; decompress it first "
                         "(zstd -d), there is no zstandard module to read it")
    return _tokens(tokenizer, "\n\n".join(
        read_json_lines(_require(path, "pile"), "text")[:max_docs]))


def get_loaders(name: str, tokenizer, nsamples: int = 128, seed: int = 0,
                seqlen: int = 2048, pile_path: Optional[str] = None,
                data_dir: str = DATA_DIR) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(train windows [nsamples, seqlen], test stream or None) by a
    substring of ``name``, as the reference's get_loaders
    (datautils.py:183-208): wikitext2, pile, ptb / ptb_new (validation /
    test), c4 / c4_new, mix (nsamples // 3 windows each of wikitext2, ptb
    and c4, no test stream)."""
    if "wikitext2" in name:
        train = load_wikitext2(tokenizer, "train", data_dir)
        test = load_wikitext2(tokenizer, "test", data_dir)
        return random_windows(train, nsamples, seqlen, seed), test
    if "pile" in name:
        if pile_path is None:
            raise ValueError("pile needs pile_path=<local val.jsonl>")
        stream = load_pile(tokenizer, pile_path)
        return random_windows(stream, nsamples, seqlen, seed), None
    if "ptb" in name:
        split = "test" if "new" in name else "validation"
        train = load_ptb(tokenizer, "train", data_dir)
        test = load_ptb(tokenizer, split, data_dir)
        return random_windows(train, nsamples, seqlen, seed), test
    if "c4" in name:
        return load_c4(tokenizer, nsamples, seqlen, seed, data_dir)
    if "mix" in name:
        k = nsamples // 3
        wiki, _ = get_loaders("wikitext2", tokenizer, k, seed, seqlen, data_dir=data_dir)
        ptb, _ = get_loaders("ptb", tokenizer, k, seed, seqlen, data_dir=data_dir)
        c4, _ = get_loaders("c4", tokenizer, k, seed, seqlen, data_dir=data_dir)
        return np.concatenate([wiki, ptb, c4], axis=0), None
    raise ValueError(f"unknown dataset {name!r} (wikitext2, ptb, ptb_new, c4, c4_new, "
                     "pile or mix; or pass a token stream)")
