"""The port's ``serve/paged.py:PagedEngine`` (explicit prefixes) against the
JAX package's ``PagedEngine(auto_prefix=False)``, on the same params
(``params_from_jax``), f32 compute, on the CPU: the cases of
``tests/test_paged_engine.py`` (greedy and sampled, chunked prefill, pooled
capacity, backpressure, copy-free prefix, partial tail, cancel, register
guards, int8 pages with and without a prefix, the three eviction tests),
``tests/test_paged_families.py`` (OPT, sliding window) and the paged cases of
``tests/test_serving_hardening.py``, each with equal greedy tokens (float
and W8A8 Llama); plus what the port adds: the writes that reach past a
row's blocks land on the scratch page, shared prefix pages are never
rewritten, and ``auto_prefix=True`` is the default. Sampled tokens come from
the port's own generator, so they are held against the port's
``ContinuousEngine`` with the same seed instead (JAX's key gives other
draws). Left out: the tensor-parallel cases (ROADMAP Queue 1, item 17);
the radix tree's and the speculative cases are in
``tests/test_torch_auto_prefix.py`` and ``tests/test_torch_speculative.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import llama as JL
from autosmoothquant_tpu.models import opt as JO
from autosmoothquant_tpu.serve.paged import PagedEngine as JaxPaged
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.models import opt as TO
from autosmoothquant_tpu_torch.models.common import PagedKVPool, QuantPagedKVPool
from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine, PrefixCacheFull
from autosmoothquant_tpu_torch.serve.paged import PagedEngine

from test_torch_util import (jax_llama, one_torch_thread, port_config,  # noqa: F401
                             port_opt_config, port_qcfg, to_numpy_tree)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
KV = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def models():
    """arm -> (JAX module, cfg, params, qcfg, port module, cfg, params,
    qcfg), built once per arm: "float" (init_params, as the JAX tests) and
    "int8" (W8A8 with calibrated scales)."""
    built = {}

    def get(arm):
        if arm not in built:
            if arm == "float":
                cfg = JL.LlamaConfig(**TINY)
                params, qcfg = JL.init_params(cfg, jax.random.PRNGKey(0)), None
            else:
                _, cfg, params, qcfg = jax_llama({"type": "int8"}, seed=21)
            built[arm] = (JL, cfg, params, qcfg, TL, port_config(cfg),
                          params_from_jax(to_numpy_tree(params), device="cpu"),
                          port_qcfg(qcfg))
        return built[arm]
    return get


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 128)
    kw.setdefault("block_size", 16)
    return kw, KV[kw.pop("kv", "f32")]


def jax_paged(models, arm="float", **kw):
    JM, cfg, params, qcfg, *_ = models(arm)
    kw, (jkv, _) = _kw(kw)
    return JaxPaged(JM, params, cfg, qcfg, kv_dtype=jkv, compute_dtype=jnp.float32,
                    auto_prefix=False, **kw)


def port_paged(models, arm="float", **kw):
    *_, TM, tcfg, tparams, tq = models(arm)
    kw, (_, tkv) = _kw(kw)
    return PagedEngine(TM, tparams, tcfg, tq, kv_dtype=tkv, compute_dtype=torch.float32,
                       auto_prefix=False, device="cpu", **kw)


def _outputs(handles):
    return {uid: r.output[:r.max_new_tokens] for uid, r in handles.items()}


def _submit_all(eng, specs):
    for uid, prompt, n, kws in specs:
        eng.submit(uid, list(prompt), max_new_tokens=n, **kws)
    return eng.run()


SPECS = [
    ("a", [3, 1, 4, 1, 5, 9, 2, 6], 10, {}),
    ("b", [9] * 17, 8, {}),
    ("c", list(range(1, 40)), 6, {}),
    ("d", [2, 8], 12, {}),
    ("e", [7, 7, 7, 7, 7], 9, {}),
    ("f", list(range(200, 230)), 5, {}),
]


def _both(models, specs, arm="float", prefix=None, **kw):
    """Run ``specs`` (after registering ``prefix``, a (id, tokens) pair, where
    given) through a new JAX and a new port engine: equal outputs and equal
    token counters. Returns the port engine."""
    engines = jax_paged(models, arm, **kw), port_paged(models, arm, **kw)
    outs = []
    for eng in engines:
        if prefix is not None:
            eng.register_prefix(*prefix)
        outs.append(_submit_all(eng, specs))
    assert outs[1] == outs[0]
    je, te = engines
    assert (te.prefill_tokens_processed, te.decode_tokens_generated) == (
        je.prefill_tokens_processed, je.decode_tokens_generated)
    return te


@pytest.mark.parametrize("arm", ["float", "int8"])
def test_matches_jax_greedy(models, arm):
    """6 requests through 4 slots; every page back on the free list after."""
    te = _both(models, SPECS, arm, steps_per_sync=3)
    assert te.free_pages == te.num_pages - 1


def test_sampled_matches_the_contiguous_engine(models):
    *_, TM, tcfg, tparams, tq = models("float")
    specs = [("s1", [5, 6, 7, 8], 8, dict(temperature=0.8, top_k=20, top_p=0.9)),
             ("s2", [11] * 9, 8, dict(temperature=1.1))]
    contiguous = ContinuousEngine(TM, tparams, tcfg, tq, max_batch=4, max_seq=128,
                                  kv_dtype=torch.float32, compute_dtype=torch.float32,
                                  seed=7, device="cpu")
    assert _submit_all(port_paged(models, seed=7), specs) == _submit_all(contiguous, specs)


def test_chunked_prefill_matches(models):
    _both(models, [("long", list(range(1, 90)), 7, {}), ("short", [4, 2], 7, {})],
          prefill_chunk=32)


def test_chunked_cold_admission(models):
    """With prefill_chunk set, a prompt without a prefix enters chunked
    admission (one chunk a tick) rather than a whole-bucket prefill."""
    pe = port_paged(models, prefill_chunk=32)
    r = pe.submit("long", list(range(1, 90)), max_new_tokens=6)
    pe._admit()
    row = next(iter(pe._admitting))
    assert pe._admitting[row]["req"] is r and pe._admitting[row]["pos"] == 0
    pe.run()
    je = jax_paged(models, prefill_chunk=32)
    je.submit("long", list(range(1, 90)), max_new_tokens=6)
    assert r.done and r.output == je.run()["long"]


def test_pooled_capacity_beyond_contiguous(models):
    """4 requests at once in 13 usable pages (contiguous rows would need
    32): each reserves ceil((3 + 10) / 16) = 1 page."""
    specs = [(f"r{i}", [i + 1, 2 * i + 1, 7], 10, {}) for i in range(4)]
    pe = port_paged(models, num_pages=14)
    handles = {uid: pe.submit(uid, p, max_new_tokens=n, **kw) for uid, p, n, kw in specs}
    pe._admit()
    assert sum(r is not None for r in pe.slot_req) == 4
    pe.run()
    assert _outputs(handles) == _submit_all(jax_paged(models, num_pages=14), specs)


def test_backpressure_when_pages_exhausted(models):
    """5 requests of 3 pages each in 6 usable pages: 2 run at once, the rest
    wait, every one completes, every page comes back."""
    specs = [(f"q{i}", list(range(1, 30)), 14, {}) for i in range(5)]
    pe = port_paged(models, num_pages=7)
    handles = {uid: pe.submit(uid, p, max_new_tokens=n, **kw) for uid, p, n, kw in specs}
    pe._admit()
    assert sum(r is not None for r in pe.slot_req) + len(pe._admitting) == 2
    assert len(pe.waiting) == 3
    pe.run()
    assert _outputs(handles) == _submit_all(jax_paged(models, num_pages=7), specs)
    assert pe.free_pages == 6


def test_prefix_sharing_is_copy_free(models):
    """3 requests over a 32-token prefix (2 full 16-token blocks) share its
    pages: reference count 1 (the registry) + 3 (the rows), one private page
    each; outputs equal JAX's and the full-prefill run's."""
    prefix = list(range(1, 33))
    specs = [(f"p{i}", prefix + [50 + i, 60 + i, 70 + i], 6, dict(prefix="sys"))
             for i in range(3)]
    pe = port_paged(models)
    pe.register_prefix("sys", prefix)
    free_after_reg = pe.free_pages
    entry = pe._prefixes["sys"]
    assert len(entry["pages"]) == 2 and entry["tail"] is None
    handles = {uid: pe.submit(uid, p, max_new_tokens=n, **kw) for uid, p, n, kw in specs}
    pe._admit()
    assert all(pe._ref[p] == 4 for p in entry["pages"])
    assert pe.free_pages == free_after_reg - 3
    pe.run()
    got = _outputs(handles)
    je = jax_paged(models)
    je.register_prefix("sys", prefix)
    assert got == _submit_all(je, specs)
    assert got == _submit_all(port_paged(models), [(u, p, n, {}) for u, p, n, _ in specs])
    assert all(pe._ref[p] == 1 for p in entry["pages"])
    pe.drop_prefix("sys")
    assert pe.free_pages == pe.num_pages - 1


def test_prefix_with_partial_tail_block(models):
    """24 tokens: 1 full block shared, the 8-token tail copied a request."""
    prefix = list(range(1, 25))
    pe = _both(models, [("x", prefix + [99, 98], 8, dict(prefix="sys"))], prefix=("sys", prefix))
    entry = pe._prefixes["sys"]
    assert len(entry["pages"]) == 1 and entry["tail"] is not None
    full = _submit_all(port_paged(models), [("y", prefix + [99, 98], 8, {})])
    assert _submit_all(pe, [("x2", prefix + [99, 98], 8, dict(prefix="sys"))])["x2"] == full["y"]


def test_cancel_frees_pages(models):
    pe = port_paged(models)
    pe.submit("gone", [1, 2, 3, 4], max_new_tokens=50)
    pe._admit()
    assert pe.free_pages < pe.num_pages - 1
    assert pe.cancel("gone")
    assert pe.free_pages == pe.num_pages - 1


def test_register_prefix_guards(models):
    pe = port_paged(models, num_pages=3)  # 2 usable
    with pytest.raises(ValueError, match="max_seq"):
        pe.register_prefix("big", list(range(1, 300)))
    with pytest.raises(PrefixCacheFull, match="free pages"):
        pe.register_prefix("wide", list(range(1, 60)))  # needs 4 pages


def test_register_prefix_failure_returns_pages(models):
    """A prefill that fails mid-registration returns its pages."""
    pe = port_paged(models)
    free0 = pe.free_pages
    orig = pe._prefill_detached

    def boom(tokens):
        raise RuntimeError("synthetic device fault")
    pe._prefill_detached = boom
    with pytest.raises(RuntimeError, match="synthetic"):
        pe.register_prefix("sys", list(range(1, 40)))
    pe._prefill_detached = orig
    assert pe.free_pages == free0 and "sys" not in pe._prefixes
    pe.register_prefix("sys", list(range(1, 40)))
    assert "sys" in pe._prefixes


@pytest.mark.parametrize("arm", ["float", "int8"])
def test_int8_kv_pages_match_jax(models, arm):
    pe = _both(models, SPECS[:4], arm, kv="int8")
    assert isinstance(pe.pool, QuantPagedKVPool)
    assert pe.free_pages == pe.num_pages - 1


def test_int8_kv_pages_prefix_sharing(models):
    prefix = list(range(1, 33))
    pe = _both(models, [("x", prefix + [9, 8, 7], 6, dict(prefix="sys"))], kv="int8",
               prefix=("sys", prefix))
    full = _submit_all(port_paged(models, kv="int8"), [("y", prefix + [9, 8, 7], 6, {})])
    assert _submit_all(pe, [("x2", prefix + [9, 8, 7], 6, dict(prefix="sys"))])["x2"] == full["y"]


def test_prefix_lru_eviction_at_cap(models):
    pe = port_paged(models, max_prefixes=2)
    pe.register_prefix("a", [1, 2, 3, 4])
    pe.register_prefix("b", [5, 6, 7, 8])
    pe.submit("r0", [1, 2, 3, 4, 9], max_new_tokens=3, prefix="a")
    pe.run()
    pe.register_prefix("c", [9, 8, 7])
    assert set(pe._prefixes) == {"a", "c"}


def test_prefix_eviction_frees_pages_for_registration(models):
    pe = port_paged(models, num_pages=9)  # 8 usable
    pe.register_prefix("a", list(range(1, 49)))   # 3 pages
    pe.register_prefix("b", list(range(1, 49)))   # 3 pages -> 2 free
    assert pe.free_pages == 2
    pe.register_prefix("c", list(range(1, 65)))   # needs 4: evicts "a"
    assert "a" not in pe._prefixes and "c" in pe._prefixes
    pe.register_prefix("d", list(range(1, 18)))   # needs 2: evicts "b"
    assert "b" not in pe._prefixes
    pe2 = port_paged(models, num_pages=9)
    assert pe2._alloc(4) is not None               # pages an active row holds
    pe2.register_prefix("a", list(range(1, 49)))   # 3 pages -> 1 free
    with pytest.raises(PrefixCacheFull, match="free pages"):
        pe2.register_prefix("huge", list(range(1, 81)))  # 5 > 4 it could free


def test_admission_evicts_idle_prefix_under_page_pressure(models):
    pe = port_paged(models, num_pages=7)  # 6 usable
    pe.register_prefix("idle", list(range(1, 49)))  # 3 pages
    pe.submit("r", list(range(1, 49)), max_new_tokens=12)  # needs 4
    out = pe.run()
    assert len(out["r"]) == 12 and "idle" not in pe._prefixes


def test_opt_paged_matches_jax():
    cfg = JO.OPTConfig(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                       num_attention_heads=4, max_position_embeddings=128,
                       word_embed_proj_dim=64, do_layer_norm_before=True)
    params = JO.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (9, 17, 33, 5)]
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    outs = []
    for eng in (JaxPaged(JO, params, cfg, max_batch=4, max_seq=128, block_size=16,
                         kv_dtype=jnp.float32, compute_dtype=jnp.float32, auto_prefix=False),
                PagedEngine(TO, tparams, port_opt_config(cfg), max_batch=4, max_seq=128,
                            block_size=16, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, auto_prefix=False, device="cpu")):
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=8)
        outs.append(eng.run())
    assert outs[1] == outs[0]


def test_sliding_window_paged_matches_jax():
    """A 24-token window binds in decode (prompts + 16 new tokens) and, at
    33 tokens, in prefill; the window is load-bearing (without it the
    tokens differ)."""
    cfg = JL.LlamaConfig(**{**TINY, "sliding_window": 24})
    params = JL.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (9, 17, 33, 5)]
    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    outs = []
    for eng in (JaxPaged(JL, params, cfg, max_batch=4, max_seq=128, block_size=16,
                         kv_dtype=jnp.float32, compute_dtype=jnp.float32, auto_prefix=False),
                PagedEngine(TL, tparams, port_config(cfg), max_batch=4, max_seq=128,
                            block_size=16, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, auto_prefix=False, device="cpu"),
                PagedEngine(TL, tparams, port_config(JL.LlamaConfig(**TINY)), max_batch=4,
                            max_seq=128, block_size=16, kv_dtype=torch.float32,
                            compute_dtype=torch.float32, auto_prefix=False, device="cpu")):
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new_tokens=16)
        outs.append(eng.run())
    assert outs[1] == outs[0]
    assert outs[2] != outs[0]


def test_writes_past_a_rows_blocks_land_on_the_scratch_page(models):
    """A parked row (position max_seq: block M, one past a slot's blocks)
    and a right-padded final chunk whose tail runs past max_seq (a 70-token
    prefix, a 127-token prompt, chunks of 32: the last chunk covers
    positions 102-133) write only their own pages and the scratch page 0:
    pages no row holds stay untouched, and the tokens equal JAX's."""
    prefix = list(range(1, 71))
    prompt = prefix + list(range(100, 157))
    specs = [("long", prompt, 1, dict(prefix="sys")), ("short", [5, 6, 7], 20, {})]
    pe = _both(models, specs, prefix=("sys", prefix), prefill_chunk=32, num_pages=40)
    # pages come off the free list from 1 up: the prefix's 5 (4 full blocks
    # and a tail), the long request's 4 private ones, the short one's 2
    used = {p for p in range(1, pe.num_pages) if bool(pe.pool.k[:, p].any())}
    assert used == set(range(1, 12))
    assert pe.pool.table.shape == (4, 128 // 16 + 1)
    assert pe.free_pages == pe.num_pages - 1 - 5


def test_parked_rows_write_distinct_scratch_slots(models):
    """More slots than a page holds (6 rows, pages of 4): each parked row
    writes its own slot of the scratch pages (2 of them), never another
    row's and never a request's page, and the tokens still equal JAX's."""
    from autosmoothquant_tpu_torch.models.common import paged_slots

    pe = _both(models, SPECS[:5], max_batch=6, max_seq=64, block_size=4)
    assert pe.scratch_pages == 2 and pe.free_pages == pe.num_pages - 2
    parked = torch.from_numpy(pe._parked_slots()).long()[:, None]
    assert bool((parked[:, 0] >= pe.max_seq).all())
    slots = paged_slots(pe.pool.table, parked, pe.block_size)
    assert slots.tolist() == list(range(6))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("route", ["banded", "window", "rows"])
def test_the_cards_chunk_route_matches_the_scan(kv, route):
    """paged_gather_attend (the card's route for a chunk of T > 1: the
    row's pages gathered, then banded flash attention, or the masked eager
    attention with a sliding window or rows at their own positions), run
    here on CPU tensors, against paged_attend_plain (JAX's scan) on the
    same shuffled pages: within 1e-5 in f32."""
    from autosmoothquant_tpu_torch.models.common import (
        _quantize_kv, cache_slots, make_paged_pool, paged_attend_plain, paged_gather_attend)

    g = torch.Generator().manual_seed(5)
    b, t, hq, hkv, d, bs, m = 2, 6, 4, 2, 16, 4, 6
    perm = torch.randperm(b * m, generator=g) + 1
    table = torch.zeros((b, m + 1), dtype=torch.int32)
    table[:, :m] = perm.reshape(b, m).int()
    pool = make_paged_pool(1, b * m + 1, bs, hkv, d, table, KV[kv][1], "cpu")
    layer = pool[0]
    kf, vf = (torch.randn(b * m + 1, bs, hkv, d, generator=g) for _ in range(2))
    if kv == "int8":
        (layer.k[:], layer.k_scale[:]), (layer.v[:], layer.v_scale[:]) = (
            _quantize_kv(kf), _quantize_kv(vf))
    else:
        layer.k[:], layer.v[:] = kf, vf
    index = torch.tensor([9, 13]) if route == "rows" else 9
    window = 5 if route == "window" else 0
    pos = cache_slots(index, b, t, "cpu")
    q = torch.randn(b, t, hq, d, generator=g)
    got = paged_gather_attend(q, layer, index, pos, 0.25, sliding_window=window)
    ref = paged_attend_plain(q, layer.k, layer.v, table, pos, 0.25, torch.float32,
                             ks_pages=layer.k_scale, vs_pages=layer.v_scale,
                             sliding_window=window)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_shared_prefix_pages_are_never_rewritten(models):
    """A second request on the same prefix (its suffix prefilled in chunks
    ending in a right-padded one) leaves the shared pages bit-equal."""
    for kv in ("f32", "int8"):
        prefix = list(range(1, 41))  # 2 full blocks and an 8-token tail
        pe = port_paged(models, kv=kv, prefill_chunk=16)
        pe.register_prefix("sys", prefix)
        entry = pe._prefixes["sys"]
        _submit_all(pe, [("a", prefix + list(range(60, 95)), 5, dict(prefix="sys"))])
        before = [t[:, entry["pages"] + [entry["tail"]]].clone() for t in pe._page_tensors()]
        _submit_all(pe, [("b", prefix + list(range(120, 171)), 5, dict(prefix="sys"))])
        after = [t[:, entry["pages"] + [entry["tail"]]] for t in pe._page_tensors()]
        assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_auto_prefix_is_the_default(models):
    """PagedEngine's default is the radix tree, as JAX's: a prompt's full
    blocks publish once its prefill completes, and a second prompt on them
    prefills only its suffix, with JAX's tokens."""
    JM, jcfg, jparams, jq, TM, tcfg, tparams, tq = models("float")
    pe = PagedEngine(TM, tparams, tcfg, tq, device="cpu", kv_dtype=torch.float32,
                     compute_dtype=torch.float32, max_batch=4, max_seq=128, block_size=16)
    je = JaxPaged(JM, jparams, jcfg, jq, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                  max_batch=4, max_seq=128, block_size=16)
    shared = list(range(1, 41))
    for eng in (pe, je):
        assert eng.auto_prefix
        eng.submit("a", shared + [50], max_new_tokens=5)
        eng.run()
        eng.submit("b", shared + [60, 61], max_new_tokens=5)
    assert pe.run() == je.run()
    assert (pe.auto_hits, pe.auto_hit_tokens, pe._auto_pages) == (1, 32, 2)


def test_pool_layout(models):
    pe = port_paged(models, num_pages=20)
    assert isinstance(pe.pool, PagedKVPool)
    assert pe.pool.k.shape == (2, 20, 16, 2, 16) and pe.pool.table.dtype == torch.int32
    assert pe.kv_cache_bytes == 2 * 2 * 20 * 16 * 2 * 16 * 4
