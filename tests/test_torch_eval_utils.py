"""The port's evaluation utilities against the JAX package on the CPU, on the
pattern of ``tests/test_tasks.py``, ``test_chat_utils.py`` and
``test_datautils.py``: ``eval/tasks.py:load_task`` (token lists equal in
all three schemas and both few-shot modes), the metric registry,
``utils/chat.py``, ``utils/datautils.py`` (the loaders read local files
where the JAX package reads ``datasets.load_dataset``, here made to return
the same records: streams and windows equal), ``utils/eval_utils.py``,
``utils/seed.py`` and ``utils/profiling.py``. The math is Python, numpy and
integer throughout, so every comparison is exact."""

import gzip
import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

from autosmoothquant_tpu.eval import harness as JH
from autosmoothquant_tpu.eval import tasks as JT
from autosmoothquant_tpu.utils import chat as JC
from autosmoothquant_tpu.utils import datautils as JD
from autosmoothquant_tpu_torch.eval import harness as TH
from autosmoothquant_tpu_torch.eval import tasks as TT
from autosmoothquant_tpu_torch.utils import chat as TC
from autosmoothquant_tpu_torch.utils import datautils as TD

VOCAB = 128


class WordTok:
    """Word-level tokenizer over integer words (tests/test_tasks.py's)."""

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[int(w) % VOCAB for w in text.split()])


class GrowTok:
    """Reversible word-level tokenizer with a growing vocabulary and a BOS
    that ``add_special_tokens`` controls."""

    def __init__(self):
        self.vocab, self.rev = {}, {}

    def __call__(self, text, add_special_tokens=True):
        ids = [999] if add_special_tokens else []
        for w in text.split():
            if w not in self.vocab:
                self.vocab[w] = len(self.vocab)
                self.rev[self.vocab[w]] = w
            ids.append(self.vocab[w])
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids):
        return " ".join(self.rev[i] for i in ids) + " "


def _write(tmp_path, name, rows):
    p = tmp_path / name
    with open(p, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(p)


def _docs(task):
    """A task's docs as plain nested lists."""
    return json.loads(json.dumps(list(task.docs)))


def _ints(node):
    if isinstance(node, list):
        for x in node:
            yield from _ints(x)
    else:
        yield node


MC = [{"query": f"q{i} w{i % 3} ", "choices": [f"a{i}", f"b{i} c", "d"], "gold": i % 3}
      for i in range(7)]
GEN = [{"input": f"x{i} y{i} z ", "target": f"t{i} u"} for i in range(6)]
ROLL = [{"text": " ".join(f"r{i}{j}" for j in range(5 + i))} for i in range(6)]
LOAD_CASES = {"mc front 2": (MC, dict(num_fewshot=2)),
              "mc random 3 described": (MC, dict(num_fewshot=3, fewshot_sample="random",
                                                 fewshot_seed=5, description="Answer.")),
              "mc limit 2": (MC, dict(num_fewshot=1, limit=2)),
              "gen front 1": (GEN, dict(num_fewshot=1, max_new_tokens=7)),
              "gen random 2": (GEN, dict(num_fewshot=2, fewshot_sample="random")),
              "rolling limit 4": (ROLL, dict(limit=4))}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_load_task_token_lists_equal_jax(tmp_path, case):
    """Each schema and few-shot mode: the same task type, name and token
    lists (contexts, choices, gold, targets, streams) as JAX's load_task,
    BOS left out of every piece."""
    rows, kw = LOAD_CASES[case]
    path = _write(tmp_path, "task.jsonl", rows)
    want = JT.load_task(path, GrowTok(), **kw)
    got = TT.load_task(path, GrowTok(), **kw)
    assert type(got).__name__ == type(want).__name__ and got.name == want.name == "task"
    assert _docs(got) == _docs(want)
    assert 999 not in set(_ints(_docs(got)))
    if hasattr(want, "max_new_tokens"):
        assert got.max_new_tokens == want.max_new_tokens


def test_schema_detection_and_fewshot(tmp_path):
    tok = WordTok()
    mc_path = _write(tmp_path, "mc.jsonl", [
        {"query": "1 2 ", "choices": ["3", "4"], "gold": 0},
        {"query": "5 6 ", "choices": ["7", "8"], "gold": 1},
        {"query": "9 10 ", "choices": ["11", "12"], "gold": 0}])
    t = TT.load_task(mc_path, tok)
    assert isinstance(t, TH.MultipleChoiceTask) and len(t.docs) == 3
    t1 = TT.load_task(mc_path, tok, num_fewshot=1)
    assert len(t1.docs) == 2 and t1.docs[0][0][:3] == [1, 2, 3]
    assert t1.docs == JT.load_task(mc_path, tok, num_fewshot=1).docs
    gen_path = _write(tmp_path, "gen.jsonl", [{"input": "1 2 ", "target": "3 4"}])
    assert isinstance(TT.load_task(gen_path, tok), TH.GenerateUntilTask)
    ppl_path = _write(tmp_path, "ppl.jsonl", [{"text": "1 2 3 4 5 6 7 8"}])
    assert isinstance(TT.load_task(ppl_path, tok), TH.RollingPPLTask)
    with pytest.raises(ValueError, match="keys"):
        TT.load_task(_write(tmp_path, "bad.jsonl", [{"foo": 1}]), tok)
    with pytest.raises(ValueError, match="empty"):
        TT.load_task(_write(tmp_path, "empty.jsonl", []), tok)
    with pytest.raises(ValueError, match="no docs left"):
        TT.load_task(mc_path, tok, num_fewshot=3)


def test_random_fewshot_excludes_self_and_is_seeded(tmp_path):
    docs = [{"query": f"q{i} ", "choices": [f"a{i}", f"b{i}"], "gold": 0} for i in range(6)]
    path = _write(tmp_path, "mc.jsonl", docs)
    tok = GrowTok()
    t1, t2, t3 = (TT.load_task(path, tok, num_fewshot=2, fewshot_sample="random",
                               fewshot_seed=s) for s in (5, 5, 6))
    assert len(t1.docs) == 6
    ctxs1 = [tuple(d[0]) for d in t1.docs]
    assert ctxs1 == [tuple(d[0]) for d in t2.docs]
    assert ctxs1 != [tuple(d[0]) for d in t3.docs]
    for i, (ctx, _, _) in enumerate(t1.docs):
        assert tok.decode(list(ctx)).count(f"q{i} ") == 1
    with pytest.raises(ValueError, match="fewshot_sample"):
        TT.load_task(path, tok, fewshot_sample="nope")


def test_metric_registry_is_the_ports_own():
    """register_metric extends the port's registry, not JAX's; the default
    entries and directions are JAX's."""
    for k in ("acc", "acc_norm", "exact_match", "perplexity", "bits_per_token"):
        assert TH.HIGHER_IS_BETTER[k] == JH.HIGHER_IS_BETTER[k]
    TH.register_metric("geom_mean", lambda v: float(np.exp(np.mean(np.log(v)))), True)
    try:
        out = TH.aggregate_metrics({"geom_mean": [1.0, 4.0]}, kinds={"geom_mean": "geom_mean"})
        assert abs(out["geom_mean"] - 2.0) < 1e-9
        assert TH.HIGHER_IS_BETTER["geom_mean"] and "geom_mean" not in JH.AGGREGATIONS
    finally:
        TH.AGGREGATIONS.pop("geom_mean", None)
        TH.HIGHER_IS_BETTER.pop("geom_mean", None)
    nll = [(10.0, 4), (6.0, 3)]
    for kind in ("mean", "sum", "perplexity", "bits_per_token"):
        v = [1.0, 2.5] if kind in ("mean", "sum") else nll
        assert TH.AGGREGATIONS[kind](v) == JH.AGGREGATIONS[kind](v)


def test_custom_metrics_example_matches_jax():
    """The port's worked F1 example against examples/custom_metrics.py:
    token F1 and the transformed generate task's aggregate."""
    import importlib.util

    from autosmoothquant_tpu_torch.eval import custom_metrics as TM

    spec = importlib.util.spec_from_file_location(
        "jax_custom_metrics", os.path.join(os.path.dirname(__file__), "..", "examples",
                                           "custom_metrics.py"))
    JM = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(JM)
    pairs = [([1, 2, 3], [1, 2, 3]), ([1, 2], [2, 5]), ([], [1]), ([], []), ([4, 4], [4])]
    assert [TM.token_f1(*p) for p in pairs] == [JM.token_f1(*p) for p in pairs]
    docs = [([1], [2, 3]), ([4], [5]), ([6], [7, 8, 9])]
    results = [[2, 3, 9], [1], [7, 8]]
    (t,) = TM.transform_tasks([TH.GenerateUntilTask(name="g", docs=docs)])
    (j,) = JM.transform_tasks([JH.GenerateUntilTask(name="g", docs=docs)])
    assert isinstance(t, TM.F1GenerateTask) and "f1" in TH.AGGREGATIONS
    assert t.aggregate(results, [0, 1, 2]) == j.aggregate(results, [0, 1, 2])
    mc = TH.MultipleChoiceTask(name="m", docs=[])
    assert TM.transform_tasks([mc]) == [mc]


def test_make_table_equals_jax():
    res = {"b": {"acc": 0.5, "acc_stderr": 0.1}, "a": {"perplexity": 12.25}}
    out = {"results": res, "versions": {"a": 0, "b": 0}, "config": {}}
    assert TH.make_table(res) == JH.make_table(res)
    assert TH.make_table(out) == JH.make_table(out)
    assert "| a | 0 | perplexity | 12.2500 |" in TH.make_table(out)


def test_qwen2_ignores_unused_sliding_window():
    from autosmoothquant_tpu_torch.models import llama as TL

    base = {"vocab_size": 8, "hidden_size": 8, "intermediate_size": 8,
            "num_hidden_layers": 1, "num_attention_heads": 1}
    assert TL.LlamaConfig.from_hf({**base, "model_type": "qwen2", "sliding_window": 32768,
                                   "use_sliding_window": False}).sliding_window == 0
    assert TL.LlamaConfig.from_hf({**base, "model_type": "mistral",
                                   "sliding_window": 4096}).sliding_window == 4096


# ---------------------------------------------------------------------------
# utils/chat.py
# ---------------------------------------------------------------------------

USER, ASSIST = 195, 196


def enc(s):
    return [sum(map(ord, w)) % 100 + 1 for w in s.split()]


CHATS = {
    "single round": ([{"role": "user", "content": "hello world"}], 64),
    "system and rounds": ([{"role": "system", "content": "be kind"},
                           {"role": "user", "content": "a b"},
                           {"role": "assistant", "content": "c"},
                           {"role": "user", "content": "d"}], 64),
    "history truncated": ([m for i in range(10) for m in (
        {"role": "user", "content": f"question{i} filler filler"},
        {"role": "assistant", "content": f"answer{i} filler"})]
        + [{"role": "user", "content": "final"}], 32),
    "ends on the assistant": ([{"role": "user", "content": "x y z"},
                               {"role": "assistant", "content": "w"}], 16),
}


@pytest.mark.parametrize("case", list(CHATS))
def test_build_chat_input_equals_jax(case):
    msgs, max_len = CHATS[case]
    kw = dict(model_max_length=max_len, max_new_tokens=8, user_token_id=USER,
              assistant_token_id=ASSIST)
    toks = TC.build_chat_input(enc, msgs, **kw)
    assert toks == JC.build_chat_input(enc, msgs, **kw)
    assert len(toks) <= max_len - 8
    if case == "system and rounds":
        assert toks == (enc("be kind") + [USER] + enc("a b") + [ASSIST] + enc("c")
                        + [USER] + enc("d") + [ASSIST])
    if msgs[-1]["role"] == "user":
        assert toks[-1] == ASSIST and enc(msgs[-1]["content"])[0] in toks


def test_system_message_must_come_first():
    msgs = [{"role": "user", "content": "a"}, {"role": "system", "content": "b"}]
    with pytest.raises(ValueError, match="first"):
        TC.build_chat_input(enc, msgs, model_max_length=16, max_new_tokens=4,
                            user_token_id=USER, assistant_token_id=ASSIST)


def test_streamer_equals_jax():
    dec = lambda toks: " ".join(str(t) for t in toks)  # noqa: E731
    out = []
    for mod in (TC, JC):
        for skip in (True, False):
            s = mod.TextIterStreamer(dec, skip_prompt=skip)
            s.put([1, 2, 3])
            s.put([4])
            s.put([5])
            s.end()
            out.append(list(s))
    assert out[:2] == out[2:] and out[0] == ["4", "4 5"]
    assert out[1] == ["1 2 3", "1 2 3 4", "1 2 3 4 5"]


# ---------------------------------------------------------------------------
# utils/datautils.py
# ---------------------------------------------------------------------------

class ToyTokenizer:
    """Word -> a stable bucket (crc32), deterministic across processes."""

    def __call__(self, text):
        import zlib

        return types.SimpleNamespace(
            input_ids=[zlib.crc32(w.encode()) % 1000 for w in text.split()])


class FakeDataset:
    """What the JAX loaders read of a ``datasets`` split: columns by name,
    rows by iteration."""

    def __init__(self, rows):
        self.rows = rows

    def __getitem__(self, key):
        return [r[key] for r in self.rows]

    def __iter__(self):
        return iter(self.rows)


def _records(seed, n, key="text", words=(3, 80)):
    rng = random.Random(seed)
    return [{key: " ".join(f"w{rng.randint(0, 400)}" for _ in range(rng.randint(*words)))}
            for _ in range(n)]


@pytest.fixture()
def datasets_dir(tmp_path, monkeypatch):
    """Local copies of wikitext2 (train, test), ptb (train, validation,
    test), c4 (its two json.gz shards) and a pile jsonl under ``tmp_path``,
    and ``datasets.load_dataset`` made to return the same records to the
    JAX loaders."""
    splits = {("wikitext", "train"): _records(1, 40), ("wikitext", "test"): _records(2, 30),
              ("ptb_text_only", "train"): _records(3, 50, "sentence"),
              ("ptb_text_only", "validation"): _records(4, 20, "sentence"),
              ("ptb_text_only", "test"): _records(5, 20, "sentence"),
              ("c4", "train"): _records(6, 60, words=(10, 300)),
              ("c4", "validation"): _records(7, 1200, words=(3, 12)),
              ("json", "train"): _records(8, 30)}
    files = {("wikitext", s): tmp_path / "wikitext2" / f"{s}.jsonl" for s in ("train", "test")}
    files.update({("ptb_text_only", s): tmp_path / "ptb" / f"{s}.jsonl"
                  for s in ("train", "validation", "test")})
    files[("json", "train")] = tmp_path / "pile.jsonl"
    for key, path in files.items():
        path.parent.mkdir(exist_ok=True)
        path.write_text("".join(json.dumps(r) + "\n" for r in splits[key]))
    (tmp_path / "c4").mkdir()
    for split, name in (("train", TD.C4_TRAIN), ("validation", TD.C4_VALIDATION)):
        with gzip.open(tmp_path / "c4" / name, "wt", encoding="utf-8") as f:
            f.write("".join(json.dumps(r) + "\n" for r in splits[("c4", split)]))

    def load_dataset(name, *a, split=None, data_files=None, **kw):
        key = "c4" if "c4" in name else name
        return FakeDataset(splits[(key, split)])

    fake = types.ModuleType("datasets")
    fake.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", fake)
    return tmp_path


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "ptb_new", "c4", "c4_new", "mix"])
def test_get_loaders_equal_jax(datasets_dir, name):
    """Each loader's train windows and test stream equal JAX's on the same
    records (wikitext2 joined with blank lines, ptb with spaces, c4's
    windows per document and its validation capped at 256 x seqlen)."""
    tok = ToyTokenizer()
    want = JD.get_loaders(name, tok, nsamples=6, seed=3, seqlen=16)
    got = TD.get_loaders(name, tok, nsamples=6, seed=3, seqlen=16, data_dir=str(datasets_dir))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    if want[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.int32
    if name.startswith("c4"):
        assert got[1].size == 256 * 16


def test_load_pile_and_dispatch_equal_jax(datasets_dir):
    tok = ToyTokenizer()
    path = str(datasets_dir / "pile.jsonl")
    np.testing.assert_array_equal(TD.load_pile(tok, path, max_docs=3),
                                  JD.load_pile(tok, path, max_docs=3))
    got = TD.get_loaders("pile", tok, nsamples=4, seqlen=32, pile_path=path)
    want = JD.get_loaders("pile", tok, nsamples=4, seqlen=32, pile_path=path)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (4, 32) and got[1] is None
    with pytest.raises(ValueError, match="pile_path"):
        TD.get_loaders("pile", tok, nsamples=4, seqlen=32)
    with pytest.raises(ValueError, match="decompress"):
        TD.load_pile(tok, path + ".zst")
    np.testing.assert_array_equal(TD.load_json_text(path, tok), JD.load_json_text(path, tok))


def test_missing_files_name_their_path(tmp_path):
    tok = ToyTokenizer()
    with pytest.raises(FileNotFoundError, match=os.path.join("wikitext2", "train.jsonl")):
        TD.get_loaders("wikitext2", tok, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match=os.path.join("ptb", "train.jsonl")):
        TD.get_loaders("ptb", tok, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match=TD.C4_TRAIN):
        TD.get_loaders("c4", tok, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="nothing.jsonl"):
        TD.load_pile(tok, str(tmp_path / "nothing.jsonl"))
    with pytest.raises(ValueError, match="unknown dataset"):
        TD.get_loaders("nope", tok)


def test_sample_doc_windows_equal_jax_and_respect_boundaries():
    tok = ToyTokenizer()
    docs = ["short doc", " ".join(f"w{i}" for i in range(64)),
            " ".join(f"v{i}" for i in range(100))]
    out = TD.sample_doc_windows(docs, tok, nsamples=8, seqlen=16, seed=0)
    np.testing.assert_array_equal(out, JD.sample_doc_windows(docs, tok, 8, 16, seed=0))
    streams = [np.asarray(tok(d).input_ids) for d in docs[1:]]
    for row in out:
        assert any(np.array_equal(row, s[i:i + 16]) for s in streams
                   for i in range(s.size - 16))
    long_doc = [" ".join(f"w{i}" for i in range(200))]
    a, b, c = (TD.sample_doc_windows(long_doc, tok, 4, 32, seed=s) for s in (7, 7, 8))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="tokenizes"):
        TD.sample_doc_windows(["a b", "c d"], tok, 2, 64, seed=0)


# ---------------------------------------------------------------------------
# utils/eval_utils.py, utils/seed.py, utils/profiling.py
# ---------------------------------------------------------------------------

def test_eval_utils_equal_jax():
    from autosmoothquant_tpu.utils import eval_utils as JE
    from autosmoothquant_tpu_torch.utils import eval_utils as TE

    names = ["arc_easy", "arc_challenge", "hellaswag", "piqa", "wikitext"]
    for pats in (["arc_*"], ["*a*", "piqa"], ["nothing"]):
        assert TE.pattern_match(pats, names) == JE.pattern_match(pats, names)
    base = lambda: {"a": {"x": 1, "y": {"z": 2}}, "b": 3}  # noqa: E731
    new = {"a": {"y": {"w": 4}, "x": 5}, "b": {"c": 6}, "d": 7}
    assert TE.update_results(base(), new) == JE.update_results(base(), new)
    assert TE.update_results(base(), new)["a"]["y"] == {"z": 2, "w": 4}


def test_setup_seed_equals_jax():
    """The same draws from Python's random and numpy's global generator
    after either package's setup_seed; the port seeds torch too."""
    from autosmoothquant_tpu.utils.seed import setup_seed as jseed
    from autosmoothquant_tpu_torch.utils.seed import setup_seed

    draws = []
    for fn in (jseed, setup_seed):
        fn(1234)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]
    setup_seed(7)
    a = torch.rand(4)
    setup_seed(7)
    assert torch.equal(a, torch.rand(4))


def test_profiling_phases_trace_and_time(tmp_path):
    """phase_report's shape as JAX's ({name: {seconds, calls}}, sorted,
    reset on request); device_trace writes its Chrome trace on the CPU;
    device_time on a CPU tensor times with the host clock."""
    import time

    from autosmoothquant_tpu_torch.utils import profiling as P

    P.phase_report(reset=True)
    for _ in range(2):
        with P.phase("b"):
            time.sleep(0.001)
    with P.phase("a"):
        pass
    rep = P.phase_report()
    assert list(rep) == ["a", "b"] and rep["b"]["calls"] == 2
    assert set(rep["b"]) == {"seconds", "calls"} and rep["b"]["seconds"] >= 0.002
    assert P.phase_report(reset=True) == rep and P.phase_report() == {}
    with P.device_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    t = P.device_time(torch.add, torch.ones(64), torch.ones(64), warmup=1, reps=5)
    assert 0 < t < 1
