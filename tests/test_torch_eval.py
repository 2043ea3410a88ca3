"""The port's evaluation (``autosmoothquant_tpu_torch/eval/``: perplexity,
``TorchLM``, the native harness, the lm-eval bridge) and its ``eval_model``
CLI against the JAX package on the CPU, on the pattern of
``tests/test_eval.py``, ``test_lm_adapter.py`` and ``test_lm_eval_adapter.py``:
the same seeded inputs through both packages, the JAX params carried across
with ``convert/from_jax.py`` (tiny Llama float and W8A8 from JAX's
``calibrate_smooth_quantize``, tiny OPT float). Tolerances, f32 compute,
each about 2-3x the largest reading on this suite's inputs: perplexity
within a relative 2e-6 (readings 4.1e-7 W8A8 to 8.9e-7 OPT), a request's
log-likelihood within 1e-5 absolute (3.8e-6), a 150-token rolling total
within 2e-5 (7.6e-6); greedy flags, generated tokens, accuracies and exact
matches equal. The CLI computes perplexity in bf16 on both sides: within a
relative 1e-4 there (3.2e-5 / 3.6e-5)."""

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.eval import harness as JH
from autosmoothquant_tpu.eval.lm_adapter import JaxLM
from autosmoothquant_tpu.models import llama as JL
from autosmoothquant_tpu.quant.config import QuantConfig as JQ
from autosmoothquant_tpu.utils.datautils import random_windows, synthetic_stream
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.eval import harness as TH
from autosmoothquant_tpu_torch.eval.lm_adapter import TorchLM, gather_results, shard_requests
from autosmoothquant_tpu_torch.eval.ppl import perplexity_from_tokens
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.models import opt as TO

from test_torch_util import jax_opt, one_torch_thread, port_opt_config, port_qcfg  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
STOCK = [str(REPO / "examples" / "tasks" / f"stock_{n}.jsonl") for n in ("mc", "gen", "rolling")]
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128)
PPL_RTOL = 2e-6
LL_ATOL = 1e-5
ROLLING_ATOL = 2e-5
CLI_PPL_RTOL = 1e-4


@dataclasses.dataclass
class Pair:
    """One model in both packages: (JAX module, cfg, params, qcfg) and the
    port's."""
    jm: object
    jcfg: object
    jparams: object
    jq: object
    tm: object
    tcfg: object
    tparams: object
    tq: object
    cache: dict = dataclasses.field(default_factory=dict)

    def lms(self, **kw):
        """(JaxLM, TorchLM) of these keywords, made once: a JaxLM compiles its
        scorer per instance, so the tests share them."""
        key = tuple(sorted(kw.items()))
        if key not in self.cache:
            self.cache[key] = (JaxLM(self.jm, self.jparams, self.jcfg, self.jq, **kw),
                               TorchLM(self.tm, self.tparams, self.tcfg, self.tq, device="cpu",
                                       **kw))
        return self.cache[key]


@pytest.fixture(scope="module")
def stream():
    return synthetic_stream(128, 2048, seed=3)


@pytest.fixture(scope="module")
def models(stream):
    from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize

    cfg = JL.LlamaConfig(**TINY)
    params = JL.init_params(cfg, jax.random.PRNGKey(1))
    tcfg = TL.LlamaConfig(**dataclasses.asdict(cfg))
    qcfg = JQ(type="int8")
    calib = random_windows(stream, 4, 64, seed=0)
    qparams, _ = calibrate_smooth_quantize(JL, params, cfg, qcfg, lambda: [calib])
    JO, ocfg, oparams, _ = jax_opt()
    tocfg = port_opt_config(ocfg)
    return {
        "float": Pair(JL, cfg, params, None, TL, tcfg,
                      params_from_jax(params, tcfg, device="cpu"), None),
        "w8a8": Pair(JL, cfg, qparams, qcfg, TL, tcfg,
                     params_from_jax(qparams, tcfg, device="cpu"), port_qcfg(qcfg)),
        "opt": Pair(JO, ocfg, oparams, None, TO, tocfg,
                    params_from_jax(oparams, tocfg, device="cpu"), None),
    }


def _ppl_both(m, tokens, **kw):
    from autosmoothquant_tpu.eval.ppl import perplexity_from_tokens as jppl

    want = jppl(m.jm, m.jparams, m.jcfg, tokens, qcfg=m.jq, **kw)
    got = perplexity_from_tokens(m.tm, m.tparams, m.tcfg, tokens, qcfg=m.tq,
                                 device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("arm,bw", [("float", 1), ("float", 3), ("w8a8", 1), ("w8a8", 3),
                                    ("opt", 1)])
def test_perplexity_matches_jax(models, stream, arm, bw):
    """Windows of 64 over 7 full windows and a remainder (dropped); batches
    of 3 end in clamped copies of the last window, which are dropped."""
    want, got = _ppl_both(models[arm], stream[:7 * 64 + 20], max_length=64, batch_windows=bw)
    assert abs(got - want) / want < PPL_RTOL, (got, want)
    if bw > 1:
        one = perplexity_from_tokens(models[arm].tm, models[arm].tparams, models[arm].tcfg,
                                     stream[:7 * 64 + 20], max_length=64, qcfg=models[arm].tq,
                                     device="cpu")
        assert abs(got - one) / one < 1e-6


def test_perplexity_matches_manual_computation(models, stream):
    """The reference's procedure by hand over the port's logits: mean CE of
    a window's 63 shifted positions times 64, exp of the sum over 4 x 64."""
    m = models["float"]
    ppl = perplexity_from_tokens(m.tm, m.tparams, m.tcfg, stream[:256], max_length=64,
                                 device="cpu")
    nlls = []
    for i in range(4):
        w = torch.from_numpy(stream[i * 64:(i + 1) * 64][None].astype(np.int64))
        h, _ = TL.forward(m.tparams, w, m.tcfg)
        logits = TL.logits(m.tparams, h)[0].double()
        logp = torch.log_softmax(logits, -1)
        nll = -logp[torch.arange(63), w[0, 1:]].mean()
        nlls.append(float(nll) * 64)
    expected = float(np.exp(np.sum(nlls) / (4 * 64)))
    assert abs(ppl - expected) / expected < 1e-5


def test_int8_perplexity_close_to_float(models, stream):
    f = models["float"]
    q = models["w8a8"]
    ppl_fp = perplexity_from_tokens(f.tm, f.tparams, f.tcfg, stream, max_length=64,
                                    device="cpu", batch_windows=8)
    ppl_q = perplexity_from_tokens(q.tm, q.tparams, q.tcfg, stream, max_length=64, qcfg=q.tq,
                                   device="cpu", batch_windows=8)
    assert abs(ppl_q - ppl_fp) / ppl_fp < 0.02, (ppl_fp, ppl_q)


def test_short_stream_and_mesh_raise(models):
    m = models["float"]
    from autosmoothquant_tpu.eval.ppl import perplexity_from_tokens as jppl

    with pytest.raises(ValueError):
        jppl(m.jm, m.jparams, m.jcfg, np.arange(10), max_length=64)
    with pytest.raises(ValueError, match="shorter than window"):
        perplexity_from_tokens(m.tm, m.tparams, m.tcfg, np.arange(10), max_length=64,
                               device="cpu")
    # a stage mesh's window batch must divide into its microbatches (JAX
    # asserts); raised before any collective
    from autosmoothquant_tpu_torch.shard.mesh import layout_mesh

    with pytest.raises(ValueError, match="microbatches"):
        perplexity_from_tokens(m.tm, m.tparams, m.tcfg, np.arange(128), max_length=64,
                               device="cpu", mesh=layout_mesh(stage=2), batch_windows=3,
                               microbatches=2)


def _assert_lls(got, want):
    assert len(got) == len(want)
    for (g, gg), (w, wg) in zip(got, want):
        assert abs(g - w) < LL_ATOL, (got, want)
        assert gg == wg and isinstance(gg, bool)


@pytest.mark.parametrize("arm", ["float", "w8a8", "opt"])
def test_loglikelihood_matches_jax(models, arm):
    """Mixed lengths in batches of 4 (sorted, right-padded to 32): each
    request's sum of continuation logprobs and its greedy flag; a request
    whose continuation is the greedy one reads True on both sides."""
    jlm, tlm = models[arm].lms(batch_size=4, max_length=64)
    rng = np.random.default_rng(5)
    reqs = [([1, 2, 3], [4, 5]), ([9], [8, 7, 6]), ([3, 3, 3, 3], [2])]
    reqs += [(rng.integers(1, 128, size=n).tolist(), rng.integers(1, 128, size=k).tolist())
             for n, k in ((5, 2), (17, 4), (30, 1), (2, 6))]
    ctx = [7, 7, 7]
    greedy = jlm.generate_until([ctx], max_new_tokens=3)[0]
    reqs.append((ctx, greedy))
    want = jlm.loglikelihood(reqs)
    _assert_lls(tlm.loglikelihood(reqs), want)
    assert want[-1][1] is True


def test_loglikelihood_truncated_context(models):
    """Over-long requests are cut on the left; the continuation is sliced
    from the end of what was scored (the JAX package's regression: a slice
    from the pre-truncation context length read 0.0)."""
    jlm, tlm = models["float"].lms(batch_size=4, max_length=64)
    rng = np.random.default_rng(11)
    ctx = list(rng.integers(1, 128, size=100))
    cont = list(rng.integers(1, 128, size=5))
    (ll, greedy), = tlm.loglikelihood([(ctx, cont)])
    _assert_lls([(ll, greedy)], jlm.loglikelihood([(ctx, cont)]))
    eff_ctx = (ctx + cont)[-64:][:-5]
    _assert_lls([(ll, greedy)], tlm.loglikelihood([(eff_ctx, cont)]))
    assert ll < -1e-3


def test_loglikelihood_oversized_continuation_raises(models):
    jlm, tlm = models["float"].lms(batch_size=4, max_length=64)
    cont = list(range(1, 70))
    with pytest.raises(ValueError):
        jlm.loglikelihood([([1, 2], cont)])
    with pytest.raises(ValueError, match="does not fit"):
        tlm.loglikelihood([([1, 2], cont)])


def test_batching_order_preserved(models):
    """Results come back in request order: batched equal to one at a time."""
    _, tlm = models["float"].lms(batch_size=4, max_length=64)
    reqs = [([i] * (1 + i % 5), [i % 7 + 1]) for i in range(11)]
    batched = tlm.loglikelihood(reqs)
    singles = [tlm.loglikelihood([r])[0] for r in reqs]
    _assert_lls(batched, singles)


def test_rolling_matches_jax(models, stream):
    """A 40-token stream (one window: equal to scoring it after the prefix
    token) and a 150-token one (three windows of 63)."""
    jlm, tlm = models["float"].lms(batch_size=4, max_length=64)
    streams = [list(np.random.default_rng(3).integers(1, 128, size=40)),
               stream[:150].tolist()]
    got = tlm.loglikelihood_rolling(streams)
    want = jlm.loglikelihood_rolling(streams)
    assert np.allclose(got, want, rtol=0, atol=ROLLING_ATOL), (got, want)
    (one, _), = tlm.loglikelihood([([0], streams[0])])
    assert abs(got[0] - one) < 1e-4


@pytest.mark.parametrize("arm", ["float", "w8a8"])
def test_generate_until_matches_jax_on_one_engine(models, arm):
    """Greedy tokens equal JAX's (an engine a call there), stop sequences cut
    them alike, and the port's LM builds one engine for both calls, its one
    decode step (b 2) run eagerly on the CPU."""
    jlm, tlm = models[arm].lms(batch_size=2, max_length=64)
    prompts = [[5, 6, 7], [1, 2], [9, 9, 9, 9, 4]]
    want = jlm.generate_until(prompts, max_new_tokens=8)
    assert tlm.generate_until(prompts, max_new_tokens=8) == want
    assert all(len(t) == 8 for t in want)
    stop = [want[0][2:4]]
    trunc = tlm.generate_until(prompts, max_new_tokens=8, stop_sequences=stop)
    assert trunc == jlm.generate_until(prompts, max_new_tokens=8, stop_sequences=stop)
    assert trunc[0] == want[0][:2]
    assert tlm.engines_built == 1 and tlm.engine.max_batch == 2
    assert tlm.engine.max_seq == 64 and tlm.engine.compute_dtype == torch.float32


def test_generate_until_task(models):
    """A doc expecting the greedy continuation scores 1, one expecting
    garbage 0: exact_match 0.5 on both sides, and the stop-sequence task 1."""
    jlm, tlm = models["float"].lms(batch_size=2, max_length=64)
    ctx = [3, 1, 4, 1, 5]
    expected = tlm.generate_until([ctx], max_new_tokens=4)[0]
    full = tlm.generate_until([[7, 7, 7]], max_new_tokens=6)[0]
    tasks = [(H.GenerateUntilTask(name="gen", docs=[(ctx, expected), (ctx, [999] * 4)],
                                  max_new_tokens=4),
              H.GenerateUntilTask(name="gen2", docs=[([7, 7, 7], full[:2])], max_new_tokens=6,
                                  stop_sequences=[[full[2]]]))
             for H in (JH, TH)]
    want = JH.evaluate(jlm, list(tasks[0]))
    got = TH.evaluate(tlm, list(tasks[1]))
    assert got == want
    assert got["gen"]["exact_match"] == 0.5 and got["gen2"]["exact_match"] == 1.0


def test_rolling_task_matches_rolling_loglikelihood(models, stream):
    jlm, tlm = models["float"].lms(batch_size=1, max_length=64)
    doc = stream[:128].tolist()
    got = TH.evaluate(tlm, [TH.RollingPPLTask(name="ppl", docs=[doc])])["ppl"]
    want = JH.evaluate(jlm, [JH.RollingPPLTask(name="ppl", docs=[doc])])["ppl"]
    ll = tlm.loglikelihood_rolling([doc])[0]
    assert abs(got["perplexity"] - float(np.exp(-ll / len(doc)))) < 1e-9
    for k in ("perplexity", "bits_per_token"):
        assert abs(got[k] - want[k]) / want[k] < PPL_RTOL
    assert got["bits_per_token"] > 0


def _mc_docs():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 128, size=4).tolist(),
             [rng.integers(1, 128, size=2).tolist() for _ in range(3)],
             int(rng.integers(0, 3))) for _ in range(6)]


def test_multiple_choice_task_and_table(models):
    jlm, tlm = models["w8a8"].lms(batch_size=4, max_length=64)
    docs = _mc_docs()
    want = JH.evaluate(jlm, [JH.MultipleChoiceTask("synthetic", docs)])
    got = TH.evaluate(tlm, [TH.MultipleChoiceTask("synthetic", docs)])
    assert got == want
    assert TH.make_table(got) == JH.make_table(want)
    assert "synthetic" in TH.make_table(got)


@pytest.mark.parametrize("kind", ["mc", "rolling"])
def test_evaluate_multirank_merge(models, stream, monkeypatch, kind):
    """world_size 2 with the gather faked in one process (as the JAX tests
    do): each rank's slice merged by request id gives the one-rank result."""
    _, tlm = models["float"].lms(batch_size=2, max_length=64)
    if kind == "mc":
        task = TH.MultipleChoiceTask(name="mc", docs=[([1, 2, 3], [[4, 5], [6]], 0),
                                                      ([7, 8], [[9], [10, 11]], 1)])
        rank = 0
    else:
        task = TH.RollingPPLTask(name="ppl2", docs=[stream[:64].tolist(),
                                                    stream[64:128].tolist()])
        rank = 1
    expect = TH.evaluate(tlm, [task])

    def fake_gather(local, world_size, group=None):
        reqs, _ = task.build_requests()
        done = {i for i, _ in local}
        other_ids = [i for i in range(len(reqs)) if i not in done]
        other = (task.run(tlm, [reqs[i] for i in other_ids]) if kind == "rolling"
                 else tlm.loglikelihood([reqs[i] for i in other_ids]))
        return local + list(zip(other_ids, other))

    monkeypatch.setattr(TH, "gather_results", fake_gather)
    assert TH.evaluate(tlm, [task], rank=rank, world_size=2) == expect


# each rank's results: uneven lists of mixed Python values
GATHER_LISTS = [[("a", 1), ("b", 2.5), ("c", [3, 4])], [], [("d", {"k": None}), ("e", b"x")]]


def _gather_rank(lists):
    import torch.distributed as dist

    return gather_results(lists[dist.get_rank()], len(lists))


def _jax_gather(lists, rank, monkeypatch):
    """JAX's ``gather_results`` as rank ``rank`` of len(lists) processes: its
    ``process_allgather`` stands in with every rank's array of each call (the
    byte counts, then the padded byte buffers)."""
    import pickle

    from autosmoothquant_tpu.eval import lm_adapter as jla
    from jax.experimental import multihost_utils

    payloads = [np.frombuffer(pickle.dumps(x), np.uint8) for x in lists]
    calls = iter([np.stack([np.asarray([p.size]) for p in payloads]),
                  np.stack([np.pad(p, (0, max(q.size for q in payloads) - p.size))
                            for p in payloads])])

    def allgather(x):
        out = next(calls)
        assert np.array_equal(out[rank].reshape(x.shape), x)
        return out

    monkeypatch.setattr(multihost_utils, "process_allgather", allgather)
    return jla.gather_results(lists[rank], len(lists))


def test_shard_and_gather_results(monkeypatch):
    """Requests shard round-robin as JAX's; one rank's results pass through;
    over 3 gloo ranks with uneven lists (one empty) every rank gathers JAX's
    list: the ranks' lists in rank order."""
    from autosmoothquant_tpu.eval.lm_adapter import shard_requests as jshard
    from autosmoothquant_tpu_torch.shard.mesh import launch

    reqs = list(range(10))
    parts = [shard_requests(reqs, r, 3) for r in range(3)]
    assert parts == [jshard(reqs, r, 3) for r in range(3)]
    assert sorted(sum(parts, [])) == reqs
    res = [("a", 1)]
    assert gather_results(res, 1) is res
    want = _jax_gather(GATHER_LISTS, 0, monkeypatch)
    assert want == sum(GATHER_LISTS, [])
    assert launch(_gather_rank, 3, GATHER_LISTS, threads=1, timeout=300) == [want] * 3


def test_bootstrap_stderr_equals_jax():
    assert TH.bootstrap_stderr([1.0] * 10) == 0.0
    for values in ([0.0, 1.0] * 20, list(np.random.default_rng(1).random(17)), [3.0]):
        assert TH.bootstrap_stderr(values) == JH.bootstrap_stderr(values)
    assert 0.02 < TH.bootstrap_stderr([0.0, 1.0] * 20) < 0.2


class StockTok:
    """Word-level tokenizer over the stock tasks' words (ids 3..), with BOS 1
    and EOS 2 and the special-token convention of HF tokenizers."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        words = set()
        for path in STOCK:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    for v in json.loads(line).values():
                        for s in (v if isinstance(v, list) else [v]):
                            if isinstance(s, str):
                                words.update(s.split())
        self.ids = {w: 3 + i for i, w in enumerate(sorted(words))}

    def __call__(self, text, add_special_tokens=True):
        ids = ([self.bos_token_id] if add_special_tokens else []) + [
            self.ids.get(w, 0) for w in text.split()]
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, toks):
        return " ".join(str(t) for t in toks)


def _stock_tasks(fewshot=1):
    from autosmoothquant_tpu.eval.tasks import load_task as jload
    from autosmoothquant_tpu_torch.eval.tasks import load_task as tload

    tok = StockTok()
    return ([jload(p, tok, num_fewshot=fewshot if "rolling" not in p else 0,
                   max_new_tokens=4) for p in STOCK],
            [tload(p, tok, num_fewshot=fewshot if "rolling" not in p else 0,
                   max_new_tokens=4) for p in STOCK])


@pytest.mark.parametrize("arm", ["float", "w8a8"])
def test_simple_evaluate_over_stock_tasks(models, arm):
    """The three stock tasks (one-shot mc and gen, rolling) through
    simple_evaluate: equal accuracies and exact matches, perplexities within
    PPL_RTOL, equal versions and config (the LM's class name aside), and the
    family tag JAX's config reads."""
    jlm, tlm = models[arm].lms(batch_size=4, max_length=64)
    jtasks, ttasks = _stock_tasks()
    want = JH.simple_evaluate(jlm, jtasks)
    got = TH.simple_evaluate(tlm, ttasks)
    assert got["versions"] == want["versions"] == {"stock_mc": 0, "stock_gen": 0,
                                                   "stock_rolling": 0}
    assert {**got["config"], "model": "JaxLM"} == want["config"]
    assert got["config"]["model"] == "TorchLM" and got["config"]["model_family"] == "llama"
    assert got["config"]["quantized"] is (arm == "w8a8")
    assert got["results"]["stock_mc"] == want["results"]["stock_mc"]
    assert got["results"]["stock_gen"] == want["results"]["stock_gen"]
    for k, v in want["results"]["stock_rolling"].items():
        assert abs(got["results"]["stock_rolling"][k] - v) / v < PPL_RTOL
    assert tlm.engines_built == 1


def test_opt_family_tag(models):
    _, tlm = models["opt"].lms(batch_size=2, max_length=64)
    docs = _mc_docs()[:2]
    out = TH.simple_evaluate(tlm, [TH.MultipleChoiceTask("t", docs)])
    assert out["config"]["model_family"] == "transformers" == models["opt"].jm.FAMILY


def test_masked_forward_matches_maskless_scoring(models):
    """The scorer passes no mask; the masked uncached path stays covered: a
    left-padded batch with its mask and positions gives each sequence's own
    logits at its valid positions, as JAX's does."""
    m = models["float"]
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 128, size=n).tolist() for n in (7, 12)]
    t = max(map(len, seqs))
    ids = np.zeros((2, t), np.int64)
    mask = np.zeros((2, t), np.int64)
    pos = np.zeros((2, t), np.int64)
    for i, s in enumerate(seqs):
        pad = t - len(s)
        ids[i, pad:] = s
        mask[i, pad:] = 1
        pos[i, pad:] = np.arange(len(s))
    h, _ = TL.forward(m.tparams, torch.from_numpy(ids), m.tcfg,
                      attention_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos))
    lg = TL.logits(m.tparams, h).numpy()
    jh, _, _ = JL.forward(m.jparams, jnp.asarray(ids, jnp.int32), m.jcfg,
                          attention_mask=jnp.asarray(mask, jnp.int32),
                          positions=jnp.asarray(pos, jnp.int32), compute_dtype=jnp.float32)
    jlg = np.asarray(JL.logits(m.jparams, jh), np.float32)
    for i, s in enumerate(seqs):
        h1, _ = TL.forward(m.tparams, torch.tensor([s]), m.tcfg)
        want = TL.logits(m.tparams, h1)[0].numpy()
        assert np.abs(lg[i, t - len(s):] - want).max() < 2e-4
        assert np.abs(lg[i, t - len(s):] - jlg[i, t - len(s):]).max() < 2e-4


# ---------------------------------------------------------------------------
# the lm-eval bridge against a stub of lm-evaluation-harness v0.4
# ---------------------------------------------------------------------------

class CharTokenizer:
    """One token per character (tests/test_lm_eval_adapter.py's)."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, s, add_special_tokens=False):
        return types.SimpleNamespace(input_ids=[3 + (ord(c) % 250) for c in s])

    def decode(self, toks):
        return "".join(chr(97 + (t % 26)) for t in toks)


class FakeInstance:
    def __init__(self, args):
        self.args = args


@pytest.fixture()
def stub_lm_eval(monkeypatch):
    """A minimal lm_eval exposing what the bridges import: simple_evaluate,
    api.model.LM and api.instance.Instance; its simple_evaluate drives every
    request type and returns what it captured."""
    lm_eval = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    api_model = types.ModuleType("lm_eval.api.model")
    api_instance = types.ModuleType("lm_eval.api.instance")

    class LM:
        def __init__(self):
            pass

    api_model.LM = LM
    api_instance.Instance = FakeInstance

    def simple_evaluate(model, tasks, num_fewshot=0, batch_size=1):
        lls = model.loglikelihood([FakeInstance(("hello", " world")), FakeInstance(("", "abc"))])
        rolling = model.loglikelihood_rolling([FakeInstance(("rolling text",))])
        gens = model.generate_until([
            FakeInstance(("prompt: ", {"until": ["\n"], "max_gen_toks": 4})),
            FakeInstance(("another prompt ", {"until": ["zz"], "max_gen_toks": 6}))])
        return {"results": {t: {"acc": 1.0} for t in tasks},
                "captured": dict(lls=lls, rolling=rolling, gens=gens)}

    lm_eval.simple_evaluate = simple_evaluate
    lm_eval.api = api
    for name, mod in (("lm_eval", lm_eval), ("lm_eval.api", api),
                      ("lm_eval.api.model", api_model), ("lm_eval.api.instance", api_instance)):
        monkeypatch.setitem(sys.modules, name, mod)


BRIDGE = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def bridge_model():
    cfg = JL.LlamaConfig(**BRIDGE)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = TL.LlamaConfig(**dataclasses.asdict(cfg))
    return cfg, params, tcfg, params_from_jax(params, tcfg, device="cpu")


def test_bridge_runs_all_request_types(stub_lm_eval, bridge_model):
    """Every request type through both bridges: log-likelihoods within
    LL_ATOL with equal greedy flags (the empty context takes BOS), the
    rolling total, and the decoded generations equal up to each request's
    own max_gen_toks."""
    from autosmoothquant_tpu.eval.lm_eval_adapter import run_lm_eval as jrun
    from autosmoothquant_tpu_torch.eval.lm_eval_adapter import run_lm_eval

    cfg, params, tcfg, tparams = bridge_model
    want = jrun(JL, params, cfg, None, CharTokenizer(), tasks=["toy"], batch_size=2,
                max_length=64)
    got = run_lm_eval(TL, tparams, tcfg, None, CharTokenizer(), tasks=["toy"], batch_size=2,
                      max_length=64, device="cpu")
    assert got["results"] == want["results"] == {"toy": {"acc": 1.0}}
    cap, jcap = got["captured"], want["captured"]
    _assert_lls(cap["lls"], jcap["lls"])
    assert all(np.isfinite(ll) and ll < 0 for ll, _ in cap["lls"])
    assert abs(cap["rolling"][0] - jcap["rolling"][0]) < ROLLING_ATOL
    # one character a token: the port keeps each request's max_gen_toks (4
    # and 6), where the JAX bridge gives every request the last one's (6)
    assert [len(g) for g in cap["gens"]] == [4, 6] and [len(g) for g in jcap["gens"]] == [6, 6]
    assert cap["gens"] == [jcap["gens"][0][:4], jcap["gens"][1]]


def test_bridge_raises_cleanly_without_lm_eval(monkeypatch, bridge_model):
    from autosmoothquant_tpu_torch.eval.lm_eval_adapter import run_lm_eval

    for m in list(sys.modules):
        if m.startswith("lm_eval"):
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "lm_eval", None)
    cfg, params, tcfg, tparams = bridge_model
    with pytest.raises(ImportError, match="native harness"):
        run_lm_eval(TL, tparams, tcfg, None, CharTokenizer(), tasks=["x"], device="cpu")


# ---------------------------------------------------------------------------
# the eval_model CLI against examples/eval_model.py
# ---------------------------------------------------------------------------

VOCAB = 512


def _stock_words():
    return sorted(StockTok().ids)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny HF Llama (2 layers, hidden 128) with a word-level tokenizer
    over the stock tasks' words and numbers, and a jsonl of 16 records of 64
    words for perplexity and calibration."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("hf_eval")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128,
        tie_word_embeddings=False, attn_implementation="eager")).eval().float() \
        .save_pretrained(d, safe_serialization=True)
    words = ["<unk>", "<s>", "</s>"] + _stock_words()
    words += [str(i) for i in range(VOCAB - len(words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(d)
    rng = np.random.default_rng(0)
    with open(d / "val.jsonl", "w") as f:
        for _ in range(16):
            f.write(json.dumps({"text": " ".join(rng.choice(words[3:], size=64))}) + "\n")
    return d


@pytest.fixture(scope="module")
def artifact(hf_dir, tmp_path_factory):
    """The port's smoothquant_model CLI's W8A8 artifact of ``hf_dir``."""
    from autosmoothquant_tpu_torch.cli import smoothquant_model

    out = tmp_path_factory.mktemp("eval_quant")
    smoothquant_model.main([
        "--model-path", str(hf_dir), "--dataset-path", str(hf_dir / "val.jsonl"),
        "--generate-scale", "--quantize-model", "--num-samples", "8", "--seq-len", "32",
        "--scale-output", str(out / "act_scales.pkl"),
        "--scale-input", str(out / "act_scales.pkl"), "--model-output", str(out)],
        device="cpu")
    (art,) = out.glob("*smoothquant-int8")
    return art


def _jax_eval_cli(argv, monkeypatch):
    """examples/eval_model.py's main on ``argv``; returns what its harness
    and perplexity computed."""
    import autosmoothquant_tpu.eval.harness as jh
    import autosmoothquant_tpu.eval.ppl as jp

    seen = {}
    evaluate, ppl = jh.evaluate, jp.perplexity_from_tokens

    def rec_evaluate(*a, **kw):
        seen["tasks"] = evaluate(*a, **kw)
        return seen["tasks"]

    def rec_ppl(*a, **kw):
        seen["ppl"] = ppl(*a, **kw)
        return seen["ppl"]

    monkeypatch.setattr(jh, "evaluate", rec_evaluate)
    monkeypatch.setattr(jp, "perplexity_from_tokens", rec_ppl)
    spec = importlib.util.spec_from_file_location("jax_eval_model",
                                                  REPO / "examples" / "eval_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval_model.py", *argv])
    mod.main()
    return seen


@pytest.mark.parametrize("which", ["artifact", "origin"])
def test_eval_model_cli_matches_jax(hf_dir, artifact, which, monkeypatch, capsys):
    """Both CLIs on the port-written W8A8 artifact (and with --origin-model
    on the float checkpoint): bf16 perplexity over 16 windows of 64 in
    batches of 4 within CLI_PPL_RTOL; the three stock tasks through the
    native harness with each package's --metrics-module F1 example: equal
    accuracies, exact matches and F1; rolling perplexity within
    PPL_RTOL. The port's stdout has the JAX CLI's shape, its report goes
    to stderr, and the harness built one engine."""
    from autosmoothquant_tpu_torch.cli import eval_model

    model = str(artifact if which == "artifact" else hf_dir)
    argv = ["--model-path", model, "--tokenizer-path", str(hf_dir), "--eval-ppl",
            "--dataset-path", str(hf_dir / "val.jsonl"), "--max-length", "64",
            "--batch-windows", "4", "--task-files", ",".join(STOCK), "--batch-size", "2",
            "--num-fewshot", "1"]
    argv += ["--origin-model"] if which == "origin" else []
    want = _jax_eval_cli(argv + ["--metrics-module", str(REPO / "examples" / "custom_metrics.py")],
                         monkeypatch)
    capsys.readouterr()
    got = eval_model.main(argv + ["--metrics-module", str(
        REPO / "autosmoothquant_tpu_torch" / "eval" / "custom_metrics.py")], device="cpu")
    out, err = capsys.readouterr()
    ppl = got["wikitext2"]["ppl"]
    assert abs(ppl - want["ppl"]) / want["ppl"] < CLI_PPL_RTOL, (ppl, want["ppl"])
    for task in ("stock_mc", "stock_gen"):
        assert got[task] == want["tasks"][task], task
    assert set(got["stock_gen"]) == {"exact_match", "exact_match_stderr", "f1", "f1_stderr"}
    for k, v in want["tasks"]["stock_rolling"].items():
        assert abs(got["stock_rolling"][k] - v) / v < PPL_RTOL
    lines = out.strip().splitlines()
    assert lines[0] == str({"results": {"wikitext2": {"ppl": ppl}}})
    assert lines[1].startswith("| task | version | metric | value |")
    report = json.loads(err.strip().splitlines()[-1])["eval_model"]
    assert report["engines_built"] == 1 and report["graphs_captured"] == 0
    assert report["ppl_tokens"] == 16 * 64 and report["device"] == "cpu"
    assert {"load", "tokenizer", "dataset", "ppl", "tasks"} <= set(report["stages_s"])


@pytest.fixture(scope="module")
def one_rank_cli(hf_dir, artifact):
    """(argv, what ``eval_model --stages 0`` prints to stdout) on the
    port-written W8A8 artifact: perplexity over 16 windows of 64 in batches
    of 4, and the three stock tasks."""
    import contextlib
    import io

    from autosmoothquant_tpu_torch.cli import eval_model

    argv = ["--model-path", str(artifact), "--tokenizer-path", str(hf_dir), "--eval-ppl",
            "--dataset-path", str(hf_dir / "val.jsonl"), "--max-length", "64",
            "--batch-windows", "4", "--microbatches", "2", "--task-files", ",".join(STOCK),
            "--batch-size", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        eval_model.main(argv + ["--stages", "0"], device="cpu")
    return argv, out.getvalue()


@pytest.mark.parametrize("flags", [["--stages", "2"], ["--tensor-parallel", "2"]])
def test_eval_model_refuses_multi_card_flags(one_rank_cli, flags, capsys):
    """``--stages 2`` and ``--tensor-parallel 2`` run 2 gloo ranks (the
    pipelined W8A8 perplexity, the tasks' requests spread over the ranks and
    gathered) and rank 0 prints what one rank prints, the perplexity's
    digits included; the report names the mesh."""
    from autosmoothquant_tpu_torch.cli import eval_model

    argv, want = one_rank_cli
    capsys.readouterr()
    eval_model.main(argv + flags, device="cpu")
    out, err = capsys.readouterr()
    assert out == want
    report = json.loads(err.strip().splitlines()[-1])["eval_model"]
    size = {"--stages": "stage", "--tensor-parallel": "model"}[flags[0]]
    assert report["mesh"][size] == 2
