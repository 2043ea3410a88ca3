"""The port's speculative decoding (``serve/speculative.py``, the speculative
branches of ``Engine.generate``, ``ContinuousEngine`` and ``PagedEngine``)
against the JAX package's, on the same params (``params_from_jax``), f32
compute, on the CPU: the cases of ``tests/test_speculative.py`` but the
tensor-parallel one (ROADMAP item 17), the paged speculative and draft-model
cases of ``tests/test_paged_engine.py`` and the draft mirror case of
``tests/test_serving_hardening.py``. Each case holds the port's tokens equal
to JAX's speculative run and to the port's own plain greedy run; the static
engine's draft-model runs hold equal [verify rounds, accepted drafts]
statistics, and the continuous engines the same adaptive-gamma ladder and
acceptance EMA after every tick. The JAX runs are shared through
module-scoped fixtures. On the card a verify's attention takes decode
attention over its queries as rows (``models/common.py:DecodeRows``); here
:func:`test_decode_rows_match_the_eager_mask` holds that route, run on CPU
tensors, to the eager attention the CPU takes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import llama as JL
from autosmoothquant_tpu.serve import batching as JB
from autosmoothquant_tpu.serve import engine as JE
from autosmoothquant_tpu.serve.paged import PagedEngine as JaxPaged
from autosmoothquant_tpu.serve.speculative import draft_ngram as jax_draft_ngram
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.serve import batching as TB
from autosmoothquant_tpu_torch.serve import engine as TE
from autosmoothquant_tpu_torch.serve.paged import PagedEngine
from autosmoothquant_tpu_torch.serve.speculative import draft_ngram

from test_torch_util import one_torch_thread, port_config, port_qcfg, to_numpy_tree  # noqa: F401

F32 = dict(compute_dtype=torch.float32)
JF32 = dict(compute_dtype=jnp.float32)


def _port(params):
    return params_from_jax(to_numpy_tree(params), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """The JAX tests' tiny Llama (vocab 128, 2 layers) and a 1-layer draft of
    it, each with its port twin: {name: (JAX cfg, JAX params, port cfg,
    port params)}."""
    cfg = JL.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=256)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    out = {"target": (cfg, params, port_config(cfg), _port(params))}
    for name, seed in (("draft9", 9), ("draft11", 11)):
        dcfg = JL.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=1, num_attention_heads=2,
                              num_key_value_heads=2, max_position_embeddings=256)
        dparams = JL.init_params(dcfg, jax.random.PRNGKey(seed))
        out[name] = (dcfg, dparams, port_config(dcfg), _port(dparams))
    return out


# JAX engines by configuration: each compiles its own steps, so a case takes
# an idle one of its configuration, set back to its constructed state
_JAX_ENGINES = {}


def _jax_engine(key, build):
    je = _JAX_ENGINES.get(key)
    if je is None:
        return _JAX_ENGINES.setdefault(key, build())
    if hasattr(je, "reset_slots"):
        je.reset_slots()
        for pid in list(je._prefixes):
            je.drop_prefix(pid)
        je._spec_acc_ema, je._spec_ticks = 1.0, 0
        je.prefill_tokens_processed = je.decode_tokens_generated = 0
        if hasattr(je, "auto_prefix"):
            je.clear_auto_prefixes()
            assert not je._ref.any()
            je._free = list(range(je.num_pages - 1, 0, -1))
            je.auto_hits = je.auto_hit_tokens = je._auto_next = je._auto_clock = 0
    return je


def engines(tiny, max_seq=128, draft=None, **kw):
    """A JAX and a port static Engine (max_batch 2, f32) on the tiny model,
    with the named draft model where given."""
    cfg, params, tcfg, tparams = tiny["target"]
    jd = td = None
    if draft is not None:
        dcfg, dparams, dtcfg, dtparams = tiny[draft]
        jd, td = JE.DraftModel(JL, dparams, dcfg), TE.DraftModel(TL, dtparams, dtcfg)
    je = _jax_engine(("static", max_seq, draft), lambda: JE.Engine(
        JL, params, cfg, None, max_batch=2, max_seq=max_seq, kv_dtype=jnp.float32, draft=jd,
        **JF32, **kw))
    te = TE.Engine(TL, tparams, tcfg, None, max_batch=2, max_seq=max_seq,
                   kv_dtype=torch.float32, device="cpu", draft=td, **F32, **kw)
    return je, te


def generate_both(je, te, prompts, **gen):
    """The speculative run on both and the port's plain greedy run: equal
    tokens, and for a draft model equal statistics. Returns the port's."""
    got = te.generate(prompts, TE.GenerationConfig(**gen))
    assert got == je.generate(prompts, JE.GenerationConfig(**gen))
    plain = {k: v for k, v in gen.items() if not k.startswith("speculative")}
    assert got == te.generate(prompts, TE.GenerationConfig(**plain))
    if je.draft is not None:
        assert te.last_spec_stats == je.last_spec_stats
    return got


class TestDraftNgram:
    def test_finds_most_recent_continuation(self):
        hist = [[1, 2, 5, 6, 3, 4, 5, 6, 7, 9, 5, 6, 0, 0]]
        got = draft_ngram(torch.tensor(hist), torch.tensor([12]), gamma=2, ngram=2)
        assert got.tolist() == [[7, 9]] == jax_draft_ngram(
            jnp.asarray(hist, jnp.int32), jnp.asarray([12], jnp.int32), 2, 2).tolist()

    def test_no_match_repeats_current(self):
        hist = [[1, 2, 3, 4, 5, 0, 0, 0]]
        got = draft_ngram(torch.tensor(hist), torch.tensor([5]), gamma=3, ngram=2)
        assert got.tolist() == [[5, 5, 5]]

    def test_random_histories_match_jax(self):
        rng = np.random.default_rng(0)
        hist = rng.integers(0, 4, size=(6, 40))
        known = rng.integers(1, 40, size=6)
        for gamma, ngram in ((4, 3), (3, 2), (2, 1)):
            want = jax_draft_ngram(jnp.asarray(hist, jnp.int32), jnp.asarray(known, jnp.int32),
                                   gamma, ngram)
            got = draft_ngram(torch.from_numpy(hist), torch.from_numpy(known), gamma, ngram)
            assert got.tolist() == np.asarray(want).tolist()


class TestGreedyEquivalence:
    def test_random_prompt_matches_greedy(self, tiny):
        rng = np.random.default_rng(0)
        ps = [rng.integers(1, 128, size=9).tolist(), rng.integers(1, 128, size=14).tolist()]
        generate_both(*engines(tiny), ps, max_new_tokens=16, speculative_gamma=4)

    def test_repetitive_prompt_matches_greedy(self, tiny):
        ps = [[7, 8, 9, 10] * 6, [3, 4] * 10]
        generate_both(*engines(tiny), ps, max_new_tokens=20, speculative_gamma=4,
                      speculative_ngram=2)

    def test_int8_quantized_path(self, tiny):
        from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize
        from autosmoothquant_tpu.quant.config import QuantConfig

        cfg, params, tcfg, _ = tiny["target"]
        rng = np.random.default_rng(1)
        calib = [rng.integers(1, 128, size=(2, 16)).astype(np.int32) for _ in range(2)]
        qcfg = QuantConfig(type="int8")
        qparams, _ = calibrate_smooth_quantize(JL, params, cfg, qcfg, lambda: iter(calib))
        je = JE.Engine(JL, qparams, cfg, qcfg, max_batch=2, max_seq=128,
                       kv_dtype=jnp.float32, **JF32)
        te = TE.Engine(TL, _port(qparams), tcfg, port_qcfg(qcfg), max_batch=2, max_seq=128,
                       kv_dtype=torch.float32, device="cpu", **F32)
        generate_both(je, te, [[5, 6] * 8], max_new_tokens=12, speculative_gamma=3)

    def test_eos_truncation(self, tiny):
        je, te = engines(tiny)
        ps = [[11, 12, 13, 14, 15]]
        base = te.generate(ps, TE.GenerationConfig(max_new_tokens=12))[0]
        assert len(base) == 12
        got = generate_both(je, te, ps, max_new_tokens=12, eos_token_id=base[5],
                            speculative_gamma=4)
        assert got[0] == base[:base.index(base[5])]

    def test_capacity_guard_includes_window(self, tiny):
        _, te = engines(tiny, max_seq=32)
        with pytest.raises(ValueError, match="speculative"):
            te.generate([[1] * 20], TE.GenerationConfig(max_new_tokens=10,
                                                        speculative_gamma=4))
        # a sampled config decodes plainly: no window to count
        te.generate([[1] * 20], TE.GenerationConfig(max_new_tokens=12, speculative_gamma=4,
                                                    temperature=1.0))


class TestDraftModel:
    def test_uncorrelated_draft_still_exact(self, tiny):
        rng = np.random.default_rng(3)
        ps = [rng.integers(1, 128, size=11).tolist(), rng.integers(1, 128, size=6).tolist()]
        generate_both(*engines(tiny, draft="draft9"), ps, max_new_tokens=14,
                      speculative_gamma=4)

    def test_identical_draft_full_acceptance_exact(self, tiny):
        rng = np.random.default_rng(4)
        ps = [rng.integers(1, 128, size=8).tolist()]
        tiny = {**tiny, "self": tiny["target"]}
        je, te = engines(tiny, draft="self")
        generate_both(je, te, ps, max_new_tokens=18, speculative_gamma=4)
        # every draft verifies: 4 rounds of 4 accepted drafts and a bonus
        assert te.last_spec_stats == [4, 16]

    def test_int4_draft_for_float_target(self, tiny):
        from autosmoothquant_tpu.quant.config import QuantConfig

        cfg, params, tcfg, tparams = tiny["target"]
        qcfg = QuantConfig(type="int4", group_size=32)
        qparams = JL.quantize(params, qcfg, None, cfg=cfg)
        rng = np.random.default_rng(5)
        ps = [rng.integers(1, 128, size=10).tolist(), rng.integers(1, 128, size=5).tolist()]
        je = JE.Engine(JL, params, cfg, None, max_batch=2, max_seq=128, kv_dtype=jnp.float32,
                       draft=JE.DraftModel(JL, qparams, cfg, qcfg), fuse_projections=False,
                       **JF32)
        te = TE.Engine(TL, tparams, tcfg, None, max_batch=2, max_seq=128,
                       kv_dtype=torch.float32, device="cpu", fuse_projections=False,
                       draft=TE.DraftModel(TL, _port(qparams), tcfg, port_qcfg(qcfg)), **F32)
        generate_both(je, te, ps, max_new_tokens=12, speculative_gamma=3)


def drive(eng, specs, seed_ema=None):
    """Run [(uid, prompt, submit kwargs)] tick by tick: (outputs, acceptance
    EMA after each tick, the gamma each tick chose)."""
    handles = {uid: eng.submit(uid, list(p), **kw) for uid, p, kw in specs}
    if seed_ema is not None:
        eng._spec_acc_ema = seed_ema
    ladder, choose = [], eng._effective_gamma

    def recording():
        g = choose()
        ladder.append(g)
        return g
    eng._effective_gamma = recording
    emas = []
    while eng.waiting or eng._admitting or any(r is not None for r in eng.slot_req):
        eng.step()
        emas.append(eng._spec_acc_ema)
    del eng._effective_gamma
    return ({uid: h.output[:h.max_new_tokens] for uid, h in handles.items()}, emas, ladder)


def continuous(tiny, paged=False, draft=None, plain=False, **kw):
    """A JAX and a port ContinuousEngine (or PagedEngine, block 16) on the
    tiny model (max_batch 4 by default, f32), and the port's plain twin."""
    cfg, params, tcfg, tparams = tiny["target"]
    jd = td = None
    if draft is not None:
        dcfg, dparams, dtcfg, dtparams = tiny[draft]
        jd, td = JE.DraftModel(JL, dparams, dcfg), TE.DraftModel(TL, dtparams, dtcfg)
    kw = {"max_batch": 4, "max_seq": 128, **kw}
    J, T = (JaxPaged, PagedEngine) if paged else (JB.ContinuousEngine, TB.ContinuousEngine)
    if paged:
        kw.setdefault("block_size", 16)
    kv = kw.pop("kv", "f32")
    jkv, tkv = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    je = _jax_engine((paged, draft, kv, tuple(sorted(kw.items()))),
                     lambda: J(JL, params, cfg, kv_dtype=jkv, draft=jd, **JF32, **kw))
    te = T(TL, tparams, tcfg, kv_dtype=tkv, device="cpu", draft=td, **F32, **kw)
    base = {k: v for k, v in kw.items() if not k.startswith("speculative")}
    pe = T(TL, tparams, tcfg, kv_dtype=tkv, device="cpu", **F32, **base)
    return je, te, pe


def run_continuous(je, te, pe, specs, seed_ema=None):
    """``specs`` through all three: the port equal to JAX in tokens, EMA
    trajectory and gamma ladder, and equal to its plain twin's tokens."""
    got, emas, ladder = drive(te, specs, seed_ema)
    want, jemas, jladder = drive(je, specs, seed_ema)
    assert got == want
    assert emas == jemas and ladder == jladder
    assert got == drive(pe, specs)[0]
    return got, emas, ladder


class TestContinuousSpeculative:
    def test_matches_plain_scheduler(self, tiny):
        rng = np.random.default_rng(2)
        prompts = [[7, 8, 9, 10] * 5, rng.integers(1, 128, size=11).tolist(), [3, 4] * 8]
        run_continuous(*continuous(tiny, speculative_gamma=4, speculative_ngram=2),
                       [(i, p, dict(max_new_tokens=10)) for i, p in enumerate(prompts)])

    def test_eos_and_stop_respected(self, tiny):
        p = [5, 6] * 8
        je, te, pe = continuous(tiny, speculative_gamma=3)
        base = drive(pe, [(0, p, dict(max_new_tokens=12))])[0][0]
        run_continuous(je, te, pe, [(1, p, dict(max_new_tokens=12, eos_token_id=base[5])),
                                    (2, p, dict(max_new_tokens=12, stop=[base[7:9]]))])

    def test_sampled_requests_fall_back(self, tiny):
        """A sampled request makes every tick plain (the port's sampler
        draws from its own generator: its tokens are held against the
        port's plain engine, JAX's only in length)."""
        rng = np.random.default_rng(3)
        p = rng.integers(1, 128, size=9).tolist()
        je, te, pe = continuous(tiny, speculative_gamma=4)
        spec = [(0, p, dict(max_new_tokens=8, temperature=1.0, top_k=10))]
        got, _, ladder = drive(te, spec)
        assert len(drive(je, spec)[0][0]) == len(got[0]) == 8
        assert got == drive(pe, spec)[0] and ladder == []

    def test_capacity_fallback(self, tiny):
        p = [int(x) for x in np.random.default_rng(4).integers(1, 128, size=110)]
        run_continuous(*continuous(tiny, speculative_gamma=4),
                       [(0, p, dict(max_new_tokens=30))])

    def test_int8_kv_matches_plain_int8_kv(self, tiny):
        run_continuous(*continuous(tiny, max_batch=2, kv="int8", speculative_gamma=3),
                       [(0, [9, 10, 11] * 6, dict(max_new_tokens=10))])


class TestAdaptiveGamma:
    def test_adaptive_matches_plain_on_random_traffic(self, tiny):
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 128, size=n).tolist() for n in (9, 14, 21, 7)]
        _, _, ladder = run_continuous(
            *continuous(tiny, speculative_gamma=4, speculative_ngram=2),
            [(i, p, dict(max_new_tokens=16)) for i, p in enumerate(prompts)])
        assert len(set(ladder)) >= 2   # gamma resized mid-run

    def test_acceptance_collapse_disables_gamma(self, tiny):
        rng = np.random.default_rng(6)
        je, te, pe = continuous(tiny, speculative_gamma=4, speculative_ngram=2)
        run_continuous(je, te, pe, [(i, rng.integers(1, 128, size=12).tolist(),
                                     dict(max_new_tokens=24)) for i in range(3)])
        assert te._spec_acc_ema < 0.2, te._spec_acc_ema
        gammas = [te._effective_gamma() for _ in range(31)]
        assert gammas == [je._effective_gamma() for _ in range(31)]
        assert gammas.count(0) >= 29 and max(gammas) <= 4

    def test_high_acceptance_keeps_full_gamma(self, tiny):
        je, te, pe = continuous(tiny, speculative_gamma=4, speculative_ngram=2)
        run_continuous(je, te, pe, [(i, [7, 8, 9] * 6, dict(max_new_tokens=24))
                                    for i in range(2)])
        assert te._spec_acc_ema > 0.5 and te._effective_gamma() == 4

    def test_fixed_mode_opts_out(self, tiny):
        _, te, _ = continuous(tiny, speculative_gamma=4, speculative_adaptive=False)
        te._spec_acc_ema = 0.0
        assert te._effective_gamma() == 4


class TestContinuousDraftModel:
    def test_draft_continuous_token_equality(self, tiny):
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, 128, size=9).tolist(), rng.integers(1, 128, size=13).tolist()]
        run_continuous(*continuous(tiny, max_batch=2, draft="draft11", speculative_gamma=3,
                                   speculative_adaptive=False),
                       [(i, p, dict(max_new_tokens=12)) for i, p in enumerate(prompts)])

    def test_draft_continuous_chunked_and_prefix(self, tiny):
        rng = np.random.default_rng(7)
        sysp = rng.integers(1, 128, size=8).tolist()
        tail = rng.integers(1, 128, size=40).tolist()
        engs = continuous(tiny, max_batch=2, draft="draft11", speculative_gamma=4,
                          speculative_adaptive=False, prefill_chunk=16)
        for e in engs:
            e.register_prefix("sys", sysp)
        run_continuous(*engs, [("a", sysp + tail[:5], dict(max_new_tokens=10, prefix="sys")),
                               ("b", tail, dict(max_new_tokens=10))])

    def test_draft_identical_model_full_acceptance(self, tiny):
        tiny = {**tiny, "self": tiny["target"]}
        je, te, pe = continuous(tiny, max_batch=1, draft="self", speculative_gamma=4,
                                speculative_adaptive=False)
        p = np.random.default_rng(8).integers(1, 128, size=10).tolist()
        run_continuous(je, te, pe, [("x", p, dict(max_new_tokens=16))])
        assert te._spec_acc_ema > 0.6, te._spec_acc_ema

    def test_draft_single_round_path(self, tiny):
        p = np.random.default_rng(9).integers(1, 128, size=7).tolist()
        run_continuous(*continuous(tiny, max_batch=2, draft="draft11", speculative_gamma=3,
                                   speculative_adaptive=False, steps_per_sync=1),
                       [(0, p, dict(max_new_tokens=10))])

    def test_plain_ticks_mirror_into_draft_pool(self, tiny):
        """tests/test_serving_hardening.py: plain ticks (a sampled request in
        the batch) mirror their tokens into the draft's pool, so that with
        the target as its own draft acceptance stays near 1 once
        speculation resumes; the greedy request's tokens are JAX's and the
        plain engine's."""
        tiny = {**tiny, "self": tiny["target"]}
        je, te, pe = continuous(tiny, max_batch=2, draft="self", speculative_gamma=3,
                                speculative_adaptive=False)
        spec = [("greedy", [3, 1, 4, 1, 5, 9], dict(max_new_tokens=30)),
                ("samp", [7, 7, 7], dict(max_new_tokens=6, temperature=0.9))]
        got = drive(te, spec)[0]
        assert got["greedy"] == drive(je, spec)[0]["greedy"] == drive(pe, spec)[0]["greedy"]
        assert te._spec_acc_ema > 0.9, te._spec_acc_ema


class TestPagedSpeculative:
    def test_paged_speculative_greedy_exact(self, tiny):
        """tests/test_paged_engine.py: prompt lookup over the paged pool, its
        verify writes through the table and its reservation counting the
        draft overhang."""
        specs = [("a", [7] * 4 + [3, 1, 4] * 6, dict(max_new_tokens=10)),
                 ("b", [9] * 17, dict(max_new_tokens=8))]
        je, te, pe = continuous(tiny, paged=True, speculative_gamma=2)
        run_continuous(je, te, pe, specs)
        assert te.free_pages == je.free_pages and te.auto_hits == je.auto_hits

    def test_paged_draft_model_greedy_exact(self, tiny):
        """tests/test_paged_engine.py: a draft model over the paged pool,
        its contiguous pool mirroring every admission path (whole bucket,
        explicit prefix, a tree hit, chunked suffixes)."""
        prefix = list(range(1, 33))
        shared = [7] * 40
        waves = [[("p0", prefix + [50, 51], dict(max_new_tokens=8, prefix="sys")),
                  ("a0", shared + [1], dict(max_new_tokens=8)),
                  ("b0", [9, 8, 7, 6, 5], dict(max_new_tokens=8))],
                 [("a1", shared + [2], dict(max_new_tokens=8))]]
        engs = continuous(tiny, paged=True, draft="draft9", speculative_gamma=3)
        for e in engs:
            e.register_prefix("sys", list(prefix))
        for wave in waves:
            run_continuous(*engs, wave)
        je, te, _ = engs
        assert te.auto_hits == je.auto_hits >= 1 and "sys" in te._dprefixes
        assert te.free_pages == je.free_pages

    def test_paged_draft_suffix_mirror_keeps_acceptance(self, tiny):
        """tests/test_paged_engine.py: a tree hit's suffix reaches the
        draft's pool, so the target as its own draft keeps acceptance near
        1."""
        tiny = {**tiny, "self": tiny["target"]}
        engs = continuous(tiny, paged=True, draft="self", speculative_gamma=3,
                          speculative_adaptive=False)
        shared = list(range(1, 49))
        for uid, tail in (("pub", 60), ("hit", 61)):
            run_continuous(*engs, [(uid, shared + [tail] * 12, dict(max_new_tokens=16))])
        assert engs[1].auto_hits == 1 and engs[1]._spec_acc_ema > 0.9


def test_parked_rows_write_their_own_scratch_slots(tiny):
    """With gamma 4 a verify writes 5 slots a parked row: the contiguous pool
    has max_seq + 5 slots a row, and a paged engine's parked rows write 5
    consecutive positions each into slots of the scratch pages no other
    row writes, for block sizes below, at and above 5 slots a row."""
    from autosmoothquant_tpu_torch.models.common import paged_slots

    cfg, params, tcfg, tparams = tiny["target"]
    te = TB.ContinuousEngine(TL, tparams, tcfg, max_batch=3, max_seq=64,
                             kv_dtype=torch.float32, device="cpu", speculative_gamma=4, **F32)
    assert te.pool[0].k.shape[1] == 64 + 5 and set(te._parked_slots()) == {64}
    for bs in (2, 5, 16):
        pe = PagedEngine(TL, tparams, tcfg, max_batch=6, max_seq=64, block_size=bs,
                         kv_dtype=torch.float32, device="cpu", speculative_gamma=4, **F32)
        parked = torch.from_numpy(pe._parked_slots()).long()[:, None] + torch.arange(5)
        slots = paged_slots(pe.pool.table, parked, bs).reshape(6, 5)
        assert bool((parked >= pe.max_seq).all())
        assert len(set(slots.reshape(-1).tolist())) == 30
        assert int(slots.max()) < pe.scratch_pages * bs
        assert pe.free_pages == pe.num_pages - pe.scratch_pages


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_writes_stay_in_each_rows_own_slots(tiny, paged):
    """A verify (gamma 4) with each row in turn active at the last length a
    verify may take and the others parked: every slot written is a row's
    own, none shared, parked rows only in their scratch slots
    (tests/test_torch_gpu.py runs it through the graphs on the card)."""
    from test_torch_util import check_verify_writes

    _, _, tcfg, tparams = tiny["target"]
    kw = dict(max_batch=6, max_seq=64, kv_dtype=torch.float32, device="cpu",
              speculative_gamma=4, **F32)
    eng = (PagedEngine(TL, tparams, tcfg, block_size=4, **kw) if paged
           else TB.ContinuousEngine(TL, tparams, tcfg, **kw))
    check_verify_writes(eng, 4)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_rows_match_the_eager_mask(kv, paged):
    """The card's verify route (decode attention over B x T queries as rows:
    a paged table repeated, or a contiguous cache as one page a row), run
    here through decode attention's plain version, equals the CPU's route
    (eager attention under the causal mask; the paged scan) within 1e-5."""
    from autosmoothquant_tpu_torch.models.common import (
        KVCacheLayer, QuantKVCacheLayer, _quantize_kv, attend, attend_rows, cache_slots,
        decode_rows, make_paged_pool, paged_attend_plain)

    g = torch.Generator().manual_seed(3)
    b, t, hq, hkv, d, s = 3, 5, 4, 2, 16, 40
    index = torch.tensor([7, 19, 33])
    slots = cache_slots(index, b, t, "cpu")
    q = torch.randn(b, t, hq, d, generator=g)
    kf, vf = (torch.randn(b, s, hkv, d, generator=g) for _ in range(2))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v = kf, vf
    if paged:
        bs, m = 8, s // 8
        perm = torch.randperm(b * m, generator=g) + 1
        table = perm.reshape(b, m).int()
        pool = make_paged_pool(1, b * m + 1, bs, hkv, d, table, KV_DTYPES[kv], "cpu")
        layer = pool[0]
        for name, src in (("k", k), ("v", v), ("k_scale", ks), ("v_scale", vs)):
            if src is not None:
                getattr(layer, name)[perm.long()] = src.reshape(b * m, bs, *src.shape[2:])
        got = attend_rows(q, layer.k, layer.v, decode_rows(table, slots, None), 0.25,
                          layer.k_scale, layer.v_scale)
        want = paged_attend_plain(q, layer.k, layer.v, table, slots, 0.25, torch.float32,
                                  ks_pages=layer.k_scale, vs_pages=layer.v_scale)
    else:
        cache = (QuantKVCacheLayer(k, v, ks, vs) if kv == "int8" else KVCacheLayer(k, v))
        valid = torch.arange(s)[None, :] >= torch.tensor([0, 3, 5])[:, None]
        got = attend_rows(q, cache.k, cache.v, decode_rows(None, slots, valid), 0.25, ks, vs)
        mask = (torch.arange(s)[None, None, None, :] <= slots[:, None, :, None]) \
            & valid[:, None, None, :]
        want = attend(q, k, v, mask, 0.25, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


KV_DTYPES = {"f32": torch.float32, "int8": torch.int8}
