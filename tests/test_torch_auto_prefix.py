"""The port's automatic prefix radix tree (``serve/paged.py:PagedEngine`` with
``auto_prefix=True``, its default) against the JAX package's, on the same
params (``params_from_jax``), f32 compute, on the CPU: the cases of
``tests/test_auto_prefix.py`` and the tree cases of
``tests/test_paged_engine.py`` and ``tests/test_serving_hardening.py``. A
case drives a JAX engine and a port engine through the same calls
(:class:`Twin`); after each run or admission both hold equal tokens, equal
``auto_hits`` / ``auto_hit_tokens``, the same tree (nodes, pages, keys),
equal ``_auto_pages``, equal page reference counts and equal free pages,
then the case's own assertions follow on the port's engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import llama as JL
from autosmoothquant_tpu.serve.batching import ContinuousEngine as JaxContinuous
from autosmoothquant_tpu.serve.paged import PagedEngine as JaxPaged
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import llama as TL
from autosmoothquant_tpu_torch.serve.paged import PagedEngine

from test_torch_util import port_config, to_numpy_tree

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
KV = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
SHARED = list(range(1, 49))  # 48 tokens = 3 full 16-token blocks


@pytest.fixture(scope="module")
def setup():
    cfg = JL.LlamaConfig(**TINY)
    params = JL.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, port_config(cfg), params_from_jax(to_numpy_tree(params), device="cpu")


@pytest.fixture(scope="module")
def contiguous(setup):
    """{(uid, prompt, budget, kv): tokens} of the JAX ContinuousEngine (which
    never shares), each request alone on a new engine, computed once."""
    cfg, params, *_ = setup
    engines, memo = {}, {}

    def run(uid, prompt, n, kv="f32"):
        key = (uid, tuple(prompt), n, kv)
        if key not in memo:
            if kv not in engines:
                engines[kv] = JaxContinuous(JL, params, cfg, max_batch=4, max_seq=128,
                                            kv_dtype=KV[kv][0], compute_dtype=jnp.float32)
            engines[kv].submit(uid, list(prompt), max_new_tokens=n)
            memo[key] = engines[kv].run()[uid]
        return memo[key]
    return run


# JAX PagedEngines by configuration: each compiles its own steps, so a case
# takes an idle one of its configuration back to its constructed state
_JAX_ENGINES = {}


def _fresh_jax(setup, kv, kw):
    cfg, params, *_ = setup
    key = (kv, tuple(sorted(kw.items())))
    je = _JAX_ENGINES.get(key)
    if je is None:
        je = _JAX_ENGINES[key] = JaxPaged(JL, params, cfg, kv_dtype=KV[kv][0],
                                          compute_dtype=jnp.float32, **kw)
        return je
    je.reset_slots()
    je.clear_auto_prefixes()
    for pid in list(je._prefixes):
        je.drop_prefix(pid)
    assert not je._ref.any()
    je._free = list(range(je.num_pages - 1, 0, -1))
    je.auto_hits = je.auto_hit_tokens = je._auto_next = je._auto_clock = 0
    je.prefill_tokens_processed = je.decode_tokens_generated = je._prefix_clock = 0
    return je


class Twin:
    """A JAX and a port PagedEngine (max_batch 4, max_seq 128, block 16 by
    default) driven through the same calls and held equal after each; the
    JAX one an idle engine of the configuration where there is one, set
    back to its constructed state (its free list in its first order)."""

    def __init__(self, setup, kv="f32", **kw):
        _, _, tcfg, tparams = setup
        kw = {"max_batch": 4, "max_seq": 128, "block_size": 16, **kw}
        self.j = _fresh_jax(setup, kv, kw)
        self.t = PagedEngine(TL, tparams, tcfg, kv_dtype=KV[kv][1],
                             compute_dtype=torch.float32, device="cpu", **kw)
        self.check()

    def submit(self, uid, prompt, n, **kw):
        """Submit to both; returns the port's request."""
        return [e.submit(uid, list(prompt), max_new_tokens=n, **kw) for e in (self.j, self.t)][1]

    def call(self, name, *args):
        out = [getattr(e, name)(*args) for e in (self.j, self.t)]
        assert out[0] == out[1], name
        self.check()
        return out[1]

    def run(self):
        return self.call("run")

    def admit(self):
        return self.call("_admit")

    def check(self):
        j, t = self.j, self.t
        assert (t.auto_hits, t.auto_hit_tokens, t._auto_pages, t.free_pages,
                t.prefill_tokens_processed, t.decode_tokens_generated) == (
            j.auto_hits, j.auto_hit_tokens, j._auto_pages, j.free_pages,
            j.prefill_tokens_processed, j.decode_tokens_generated)
        assert np.array_equal(t._ref, j._ref) and t._row_pages == j._row_pages

        def tree(e):
            return {nid: (n["page"], n["parent"], n["key"], sorted(n["children"]))
                    for nid, n in e._auto_nodes.items()}
        assert tree(t) == tree(j) and t._auto_root == j._auto_root
        assert t.scratch_pages == 1


def accounting_ok(pe):
    """Free + held pages (held: a reference count above 0) cover every page
    that is not a scratch page."""
    held = int((pe._ref[pe.scratch_pages:] > 0).sum())
    return pe.free_pages + held == pe.num_pages - pe.scratch_pages


def chain_nids(pe):
    out, children = [], pe._auto_root
    while children:
        _, nid = next(iter(children.items()))
        out.append(nid)
        children = pe._auto_nodes[nid]["children"]
    return out


def test_auto_sharing_token_equality(setup, contiguous):
    tw = Twin(setup)
    for i in range(4):
        p = SHARED + [60 + i, 70 + i, 80 + i]
        tw.submit(f"r{i}", p, 8)
        assert tw.run()[f"r{i}"] == contiguous(f"r{i}", p, 8)
    pe = tw.t
    assert (pe.auto_hits, pe.auto_hit_tokens) == (3, 3 * 48)
    assert pe.prefill_tokens_processed == 51 + 3 * 3
    assert accounting_ok(pe)


def test_auto_sharing_is_copy_free(setup):
    tw = Twin(setup)
    pe = tw.t
    tw.submit("first", SHARED + [99], 4)
    tw.run()
    tree_pages = {n["page"] for n in pe._auto_nodes.values()}
    assert len(tree_pages) == 3 and pe._auto_pages == 3
    assert all(pe._ref[p] == 1 for p in tree_pages)
    tw.submit("second", SHARED + [98], 4)
    tw.admit()
    assert all(pe._ref[p] == 2 for p in tree_pages)
    row = next(iter(pe._admitting))
    assert pe._row_pages[row][:3] == [pe._auto_nodes[n]["page"] for n in chain_nids(pe)]
    tw.run()
    assert all(pe._ref[p] == 1 for p in tree_pages)
    assert accounting_ok(pe)


def test_partial_overlap_matches_longest_chain(setup):
    tw = Twin(setup)
    tw.submit("a", SHARED + [7], 4)
    tw.run()
    for prompt, want in ((SHARED[:32] + [200, 201, 202], 32), ([5] + SHARED[1:] + [7], 0),
                         (SHARED, 32)):
        pages, matched = tw.call("_auto_match", prompt)
        assert matched == want and len(pages) == want // 16


def test_forked_prompts_build_a_tree(setup, contiguous):
    tw = Twin(setup)
    base = SHARED[:16]
    pa = base + list(range(100, 116)) + [1, 2]
    pb = base + list(range(120, 136)) + [3, 4]
    for u, p in (("a", pa), ("b", pb)):
        tw.submit(u, p, 5)
        assert tw.run()[u] == contiguous(u, p, 5)
    pe = tw.t
    assert len(pe._auto_root) == 1
    assert len(pe._auto_nodes[next(iter(pe._auto_root.values()))]["children"]) == 2
    assert tw.call("_auto_match", pb + [9])[1] == 32


def test_eviction_under_page_pressure(setup):
    tw = Twin(setup, num_pages=10, max_auto_pages=8)
    rng = np.random.default_rng(3)
    outs = {}
    for i in range(6):
        tw.submit(f"d{i}", rng.integers(1, 256, size=33).tolist(), 6)
        outs.update(tw.run())
    pe = tw.t
    assert all(len(v) == 6 for v in outs.values())
    assert pe._auto_pages <= pe.max_auto_pages and accounting_ok(pe)
    assert all(n["parent"] is None or n["parent"] in pe._auto_nodes
               for n in pe._auto_nodes.values())


def test_auto_off_flag(setup):
    tw = Twin(setup, auto_prefix=False)
    for u, tail in (("x", 9), ("y", 8)):
        tw.submit(u, SHARED + [tail], 4)
        tw.run()
    pe = tw.t
    assert pe.auto_hits == 0 and pe._auto_pages == 0 and pe.max_auto_pages == 0
    assert pe.free_pages == pe.num_pages - 1


def test_explicit_prefix_pages_republish_to_tree(setup):
    tw = Twin(setup)
    tw.call("register_prefix", "sys", SHARED[:32])
    tw.submit("with", SHARED[:32] + [9, 9], 4, prefix="sys")
    tw.run()
    tw.submit("without", SHARED[:32] + [8, 8], 4)
    tw.admit()
    pe = tw.t
    assert (pe.auto_hits, pe.auto_hit_tokens) == (1, 32)
    assert {n["page"] for n in pe._auto_nodes.values()} == set(pe._prefixes["sys"]["pages"])
    tw.run()
    assert accounting_ok(pe)


def test_int8_pages_auto_sharing(setup, contiguous):
    tw = Twin(setup, kv="int8")
    for u, tail in (("i0", 11), ("i1", 12)):
        p = SHARED + [tail]
        tw.submit(u, p, 6)
        assert tw.run()[u] == contiguous(u, p, 6, "int8")
    assert (tw.t.auto_hits, tw.t.auto_hit_tokens) == (1, 48)


def test_concurrent_batch_shares_after_first_completes(setup, contiguous):
    tw = Twin(setup)
    specs = [(f"c{i}", SHARED + [30 + i]) for i in range(6)]
    for u, p in specs:
        tw.submit(u, p, 6)
    got = tw.run()
    assert got == {u: contiguous(u, p, 6) for u, p in specs}
    assert tw.t.auto_hits >= 2 and accounting_ok(tw.t)


def test_cancel_during_auto_admission_releases_shares(setup):
    tw = Twin(setup)
    pe = tw.t
    tw.submit("pub", SHARED + [99], 4)
    tw.run()
    tree_pages = {n["page"] for n in pe._auto_nodes.values()}
    tw.submit("doomed", SHARED + [98, 97], 4)
    tw.admit()
    assert all(pe._ref[p] == 2 for p in tree_pages)
    assert tw.call("cancel", "doomed")
    assert all(pe._ref[p] == 1 for p in tree_pages) and accounting_ok(pe)
    tw.submit("next", SHARED + [96], 4)
    assert len(tw.run()["next"]) == 4 and pe.auto_hits == 2


def test_clear_auto_prefixes_and_reset_return_every_page(setup):
    """clear_auto_prefixes drops the tree's references; with reset_slots
    (a request mid-admission on the tree) every page comes back."""
    tw = Twin(setup)
    tw.submit("x", SHARED + [9], 4)
    tw.run()
    assert tw.t._auto_pages == 3
    tw.submit("y", SHARED + [8, 7], 4)
    tw.admit()
    tw.call("reset_slots")
    tw.call("clear_auto_prefixes")
    assert tw.t._auto_pages == 0 and tw.t.free_pages == tw.t.num_pages - 1


def test_matches_contiguous_engine_greedy_with_tree(setup, contiguous):
    """tests/test_paged_engine.py's first case with the tree on: slot churn
    (6 requests through 4 slots), every page back but the tree's."""
    specs = [("a", [3, 1, 4, 1, 5, 9, 2, 6], 10), ("b", [9] * 17, 8),
             ("c", list(range(1, 40)), 6), ("d", [2, 8], 12), ("e", [7, 7, 7, 7, 7], 9),
             ("f", list(range(200, 230)), 5)]
    tw = Twin(setup, steps_per_sync=3)
    for u, p, n in specs:
        tw.submit(u, p, n)
    assert tw.run() == {u: contiguous(u, p, n) for u, p, n in specs}
    pe = tw.t
    assert pe.free_pages == pe.num_pages - 1 - pe._auto_pages
    tw.call("clear_auto_prefixes")
    assert pe.free_pages == pe.num_pages - 1


def test_backpressure_shares_published_blocks(setup, contiguous):
    """tests/test_paged_engine.py's backpressure case with the tree: 5
    identical prompts through 6 usable pages, at most 2 at once."""
    tw = Twin(setup, num_pages=7)
    p = list(range(1, 30))
    reqs = [tw.submit(f"q{i}", p, 14) for i in range(5)]
    tw.admit()
    pe = tw.t
    assert sum(r is not None for r in pe.slot_req) + len(pe._admitting) == 2
    tw.run()
    assert all(r.output[:14] == contiguous("q", p, 14) for r in reqs)
    assert pe.auto_hits >= 1 and pe.free_pages == 6 - pe._auto_pages


def test_registered_prefix_copy_free_and_republished(setup):
    """tests/test_paged_engine.py's copy-free prefix case: 3 requests on a
    2-block registered prefix share its pages (ref 4), and on completion
    the tree holds the same pages (ref 2: registry and tree)."""
    tw = Twin(setup)
    pe = tw.t
    prefix = list(range(1, 33))
    tw.call("register_prefix", "sys", prefix)
    free_after = pe.free_pages
    entry = pe._prefixes["sys"]
    for i in range(3):
        tw.submit(f"p{i}", prefix + [50 + i, 60 + i, 70 + i], 6, prefix="sys")
    tw.admit()
    assert all(pe._ref[p] == 4 for p in entry["pages"]) and pe.free_pages == free_after - 3
    tw.run()
    assert all(pe._ref[p] == 2 for p in entry["pages"])
    assert {n["page"] for n in pe._auto_nodes.values()} == set(entry["pages"])
    tw.call("clear_auto_prefixes")
    tw.call("drop_prefix", "sys")
    assert pe.free_pages == pe.num_pages - 1


def test_pressure_eviction_never_destroys_shared_cache(setup):
    """tests/test_serving_hardening.py: when every evictable tree page is
    shared by a live row, admission waits instead of emptying the tree."""
    tw = Twin(setup, num_pages=12, max_batch=2)
    pe = tw.t
    tw.submit("pub", SHARED + [60] * 12, 4)
    tw.run()
    assert pe._auto_pages == 3
    tw.submit("a", SHARED + [61], 40)
    tw.submit("b", SHARED + [62], 40)
    tw.admit()
    while pe._admitting:
        tw.call("step")
    assert all(pe._ref[n["page"]] >= 2 for n in pe._auto_nodes.values())
    free_before = pe.free_pages
    tw.submit("big", list(range(100, 190)), 20)
    tw.admit()
    assert pe._auto_pages == 3 and pe.free_pages == free_before
    assert pe.waiting and pe.waiting[0].uid == "big"
    assert len(tw.run()["big"]) == 20
