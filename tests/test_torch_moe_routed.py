"""Mixtral's routed decode route (``models/mixtral.py:moe_routed``) and its
two kernels' plain versions (``kernels/moe.py``: the routing and the
expert-indexed GEMV), on the CPU, at the tiny config of
tests/test_torch_mixtral.py (hidden 64, 4 experts of 96, top 2).

The routed route runs each expert a step's rows picked over all of them,
from the same quantized operands, through the same plain matmuls, and
combines in the same order as the dense route, so the two are compared bit
for bit (``torch.equal``) at T = 1, 2, 5 and 8 in every format that takes
it; the routing's plain version is compared bit for bit with the routing
code it replaced, and the expert GEMV's with a loop of ``int8_matmul_plain``
/ ``fp8_matmul_plain`` over the picked experts."""

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.kernels import moe
from autosmoothquant_tpu_torch.kernels.fp8 import fp8_matmul_plain
from autosmoothquant_tpu_torch.kernels.gemm import int8_matmul_plain
from autosmoothquant_tpu_torch.models import mixtral as TM
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_mixtral import models  # noqa: F401  (module fixture)
from test_torch_util import one_torch_thread  # noqa: F401

# the formats the routed route takes (W8A8 at every granularity, fp8 e4m3
# dynamic, e5m2) and those that keep the dense route
ROUTED = ("int8", "int8_mixed", "int8_per_token", "fp8_e4m3", "fp8_e5m2")
DENSE = ("float", "fp8_e4m3_static", "int4")
QUANT_E5M2 = {"type": "fp8_e5m2"}


@pytest.fixture(scope="module")
def formats(models):  # noqa: F811
    """get(quant) -> (port cfg, port params, port qcfg); e5m2 is packed from
    the float model by the port's own quantize."""
    built = {}

    def get(quant):
        if quant not in built:
            if quant == "fp8_e5m2":
                _, tcfg, _, tp, *_ = models("float")
                tq = TQ(**QUANT_E5M2)
                built[quant] = (tcfg, TM.quantize(tp, tq, cfg=tcfg), tq)
            else:
                _, tcfg, _, tp, _, tq, _ = models(quant)
                built[quant] = (tcfg, tp, tq)
        return built[quant]
    return get


def _old_route(x2, router, k):
    """The routing the port ran before the routing kernel: the f32 logits, a
    softmax, a stable descending sort, its first k, renormalized."""
    probs = torch.softmax(x2.float() @ router.float(), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_idx


def _norm_output(tq, rows, seed):
    """A second norm's output at the format's scale (int8 units for W8A8)."""
    scale = 30.0 if tq is not None and tq.is_int8 else 1.0
    return torch.from_numpy(
        (scale * np.random.default_rng(seed).normal(size=(rows, 64))).astype(np.float32))


def _planted(T, E=4):
    """A routing whose rows share experts: expert 0 is every row's, the
    other pick walks over the rest (rows 0 and 3 pick the same pair), with
    expert 0 first or second by row; weights renormalized."""
    other = torch.tensor([1 + (t % (E - 1)) for t in range(T)])
    idx = torch.stack([torch.zeros(T, dtype=torch.long), other], dim=1)
    idx[1::2] = idx[1::2].flip(1)
    w = torch.rand(T, 2, generator=torch.Generator().manual_seed(T)) + 0.1
    return (w / w.sum(-1, keepdim=True)).float(), idx


@pytest.mark.parametrize("T", [1, 2, 5, 8])
@pytest.mark.parametrize("quant", ROUTED)
def test_routed_equals_dense_bit_for_bit(formats, quant, T):
    """moe_routed against moe_dense on the router's own routing and on a
    planted one (rows sharing experts, one expert picked by every row)."""
    tcfg, tp, tq = formats(quant)
    mp = tp["layers"][1]["moe"]
    assert TM.routed_format(tq, mp)
    x = _norm_output(tq, T, 40 + T)
    for top_w, top_idx in (TM.route(x, mp["router"]["w"], 2), _planted(T)):
        dense = TM.moe_dense(x, mp, tcfg, tq, torch.float32, top_w, top_idx)
        routed = TM.moe_routed(x, mp, tcfg, tq, torch.float32, top_w, top_idx)
        assert torch.isfinite(routed).all()
        assert torch.equal(routed, dense), quant


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
def test_routed_equals_dense_at_a_planted_tie(formats, quant):
    """Experts 1 and 3 given one router column: their probabilities tie
    exactly in every row, expert 1 is taken before 3 (never 3 without 1),
    and the routed route still gives the dense route's bits."""
    tcfg, tp, tq = formats(quant)
    mp = dict(tp["layers"][0]["moe"])
    router = mp["router"]["w"].clone()
    router[:, 3] = router[:, 1]
    mp["router"] = {"w": router}
    x = _norm_output(tq, 8, 77)
    r = moe.moe_route(x, router, 2, with_logits=True)
    assert torch.equal(r.logits[:, 1], r.logits[:, 3])
    picked = 0
    for row in r.top_idx.tolist():
        assert 3 not in row or row == [1, 3]
        picked += 1 in row
    assert picked > 0
    dense = TM.moe_dense(x, mp, tcfg, tq, torch.float32, r.top_w, r.top_idx)
    routed = TM.moe_routed(x, mp, tcfg, tq, torch.float32, r.top_w, r.top_idx,
                           (r.combine_rows, r.combine_w))
    assert torch.equal(routed, dense)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_plain_is_the_old_route(models, k):  # noqa: F811
    """moe_route's plain version (the CPU's) gives the old routing's bits, k
    = E (all experts) included; ``combine_rows`` lists each row's picks in
    ascending expert order (e T + t) with ``combine_w`` their weights;
    mixtral.route returns the first two."""
    _, tcfg, _, tp, *_ = models()
    router = tp["layers"][0]["moe"]["router"]["w"]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(24, 64)).astype(np.float32))
    r = moe.moe_route(x, router, k, with_logits=True)
    want_w, want_idx = _old_route(x, router, k)
    assert torch.equal(r.top_w, want_w) and torch.equal(r.top_idx, want_idx)
    assert torch.equal(r.logits, moe.router_logits_plain(x, router))
    T = x.shape[0]
    rows = torch.arange(T)[:, None]
    asc = (r.combine_rows - rows) // T
    assert bool((asc[:, 1:] > asc[:, :-1]).all()) and torch.equal((r.combine_rows - rows) % T,
                                                                   torch.zeros_like(asc))
    assert torch.equal(asc.sort(-1).values, r.top_idx.sort(-1).values)
    assert torch.equal(r.combine_w, r.top_w.gather(1, r.top_idx.argsort(-1)))
    tw, ti = TM.route(x, router, k)
    assert torch.equal(tw, want_w) and torch.equal(ti, want_idx)
    assert moe.moe_route(x, router, k).logits is None


def test_route_ties_take_the_lower_expert():
    """Equal probabilities (one router column twice, or two that underflow
    to 0) are taken lower expert first, as lax.top_k takes them."""
    w = torch.zeros(8, 6)
    w[:, 2] = w[:, 4] = 1.0
    w[:, 0] = w[:, 5] = -200.0
    r = moe.moe_route(torch.ones(3, 8), w, 6)
    assert r.top_idx.tolist() == [[2, 4, 1, 3, 0, 5]] * 3
    assert (r.combine_rows // 3).tolist() == [[0, 1, 2, 3, 4, 5]] * 3
    assert torch.equal(r.combine_w, r.top_w[:, [4, 2, 0, 3, 1, 5]])
    assert torch.equal(r.top_w[:, 4:], torch.zeros(3, 2))


def _expert_case(fmt, M, E=4, N=48, K=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    if fmt == "int8":
        w = torch.randint(-127, 128, (E, N, K), generator=g, dtype=torch.int8)
        x = torch.randint(-127, 128, (E, M, K), generator=g, dtype=torch.int8)
    else:
        w = (torch.randn(E, N, K, generator=g) * 4).to(torch.float8_e4m3fn)
        x = (torch.randn(E, M, K, generator=g) * 4).to(torch.float8_e4m3fn)
    return x, w, torch.rand(E, generator=g) + 0.5, torch.rand(E, M, 1, generator=g) + 0.5


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_expert_gemv_plain_is_a_loop_over_the_picked_experts(fmt, M):
    """expert_gemv on CPU tensors: each picked expert's int8_matmul_plain /
    fp8_matmul_plain over all M rows, with its own scales (shared or its own
    x, row scales shared or its own, column scales [E] or [E, N]), and
    zeros for every expert no row picked."""
    x, w, cs, rs = _expert_case(fmt, M)
    mm = int8_matmul_plain if fmt == "int8" else fp8_matmul_plain
    ids = torch.tensor([[2, 0], [0, 2], [2, 0]] * 3)[:M]
    cols = cs[:, None] * torch.linspace(0.5, 1.5, w.shape[1])[None, :]
    for shared_x, row_scale, col_scale in ((True, None, cs), (True, rs[0], cols),
                                           (False, rs, cs), (False, rs[:, :1], None)):
        xin = x[0] if shared_x else x
        got = moe.expert_gemv(xin, w, ids, row_scale, col_scale, out_dtype=torch.float32)
        assert got.shape == (4, M, w.shape[1])
        for e in range(4):
            if e not in (0, 2):
                assert torch.equal(got[e], torch.zeros_like(got[e]))
                continue
            rse = 1.0 if row_scale is None else (row_scale[e] if row_scale.ndim == 3
                                                   else row_scale)
            cse = 1.0 if col_scale is None else col_scale[e]
            want = mm(xin if shared_x else x[e], w[e], rse, cse, out_dtype=torch.float32)
            assert torch.equal(got[e], want), (fmt, e, shared_x)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_expert_gemv_pair_is_two_projections(fmt):
    """A pair of weights (w1 and w3: one launch on the card) gives each
    projection's own outputs."""
    x, w, cs, rs = _expert_case(fmt, 3)
    w3, cs3 = torch.roll(w, 1, 0), cs.flip(0)
    ids = torch.tensor([[3, 1], [1, 0], [3, 0]])
    g, u = moe.expert_gemv(x[0], (w, w3), ids, rs[0], (cs, cs3))
    assert torch.equal(g, moe.expert_gemv(x[0], w, ids, rs[0], cs))
    assert torch.equal(u, moe.expert_gemv(x[0], w3, ids, rs[0], cs3))
    g, u = moe.expert_gemv(x[0], [w, w3], ids)
    assert torch.equal(u, moe.expert_gemv(x[0], w3, ids))
    with pytest.raises(ValueError):
        moe.expert_gemv(x[0], (w, w3[:, :8]), ids)


def test_expert_gemv_checks_its_operands():
    """Shapes, dtypes and ids of another kind raise."""
    x, w, cs, rs = _expert_case("int8", 2)
    ids = torch.tensor([[0, 1], [1, 2]])
    with pytest.raises(ValueError):
        moe.expert_gemv(x[0], w[:, :, :32], ids)
    with pytest.raises(TypeError):
        moe.expert_gemv(x[0].float(), w, ids)
    with pytest.raises(ValueError):
        moe.expert_gemv(x[0], w, ids.int())
    with pytest.raises(ValueError):
        moe.expert_gemv(x[0], w, ids[:1])


@pytest.fixture
def spy(monkeypatch):
    """Counts of moe_routed, moe_dense and moe_sparse calls in the module."""
    calls = {"routed": 0, "dense": 0, "sparse": 0}
    for name in calls:
        fn = getattr(TM, f"moe_{name}")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(TM, f"moe_{name}", counted)
    return calls


@pytest.mark.parametrize("quant", ROUTED + DENSE)
def test_moe_block_takes_the_routed_route_at_most_8_rows(formats, spy, quant):
    """moe_block: routed at T <= 8 in the formats that take it, dense at 8 <
    T < 4 E = 16 (and at T <= 8 in the others), sparse from 16; never
    routed under statistics capture or all-experts calibration."""
    tcfg, tp, tq = formats(quant)
    mp = tp["layers"][0]["moe"]
    routed = quant in ROUTED
    for T, want in ((1, "routed"), (8, "routed"), (9, "dense"), (15, "dense"),
                    (16, "sparse")):
        if want == "routed" and not routed:
            want = "dense"
        before = dict(spy)
        out = TM.moe_block(_norm_output(tq, T, T), mp, tcfg, tq, torch.float32)
        assert out.shape == (T, 64) and torch.isfinite(out).all()
        assert {k: spy[k] - before[k] for k in spy} == {
            k: int(k == want) for k in spy}, (quant, T)
    before = dict(spy)
    TM.moe_block(_norm_output(tq, 4, 0), mp, tcfg, tq, torch.float32, all_experts=True)
    TM.moe_block(_norm_output(tq, 4, 0), mp, tcfg, tq, torch.float32, stats={})
    assert spy["routed"] == before["routed"] and spy["dense"] == before["dense"] + 2
