"""The port's kernel modules (their plain PyTorch versions, which CPU tensors
take) against the JAX package's Pallas kernels run in interpret mode.

Tolerances: int8_matmul f32 out rtol 1e-6 (one f32 rounding of the exact
int32 accumulator, then two scale products) and int8 out equal;
fused_add_rmsnorm_quant s equal and q within one step on <= 0.1% of elements
(the f32 sum of squares runs in another order); flash attention f32 atol 1e-5
on valid rows (a row with no valid key is 0 in both kernels). Route and
split rules (K1, K4, K5, K6) and K3's head-dim padding are checked on the
shapes alone."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.kernels import attention as JA
from autosmoothquant_tpu.kernels import fused as JF
from autosmoothquant_tpu.kernels import gemm as JG
from autosmoothquant_tpu_torch.kernels import attention as TA
from autosmoothquant_tpu_torch.kernels import fused as TF
from autosmoothquant_tpu_torch.kernels import gemm as TG


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("m,n,k", [(64, 256, 256), (32, 128, 384)])
@pytest.mark.parametrize("variant", ["scalar", "per_token_bias", "col_vector_silu"])
def test_int8_matmul_f32_matches_pallas(m, n, k, variant):
    rng = np.random.default_rng(m + n + k)
    x, w = _int8((m, k), 1), _int8((k, n), 2)
    rs, cs, bias, act = 1.0, np.float32(0.003), None, None
    if variant == "per_token_bias":
        rs = (rng.random((m, 1)) + 0.1).astype(np.float32)
        bias = rng.normal(size=n).astype(np.float32)
    if variant == "col_vector_silu":
        cs = (rng.random(n) * 1e-3).astype(np.float32)
        act = "silu"
    j = JG.int8_matmul(jnp.asarray(x), jnp.asarray(w), row_scale=rs, col_scale=cs,
                       bias=None if bias is None else jnp.asarray(bias),
                       activation=act, use_pallas=True, interpret=True)
    t = TG.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                       row_scale=torch.as_tensor(rs), col_scale=torch.as_tensor(cs),
                       bias=None if bias is None else torch.from_numpy(bias),
                       activation=act)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_int8_matmul_int8_out_matches_pallas_exactly():
    x, w = _int8((64, 256), 3), _int8((256, 256), 4)
    j = JG.int8_matmul(jnp.asarray(x), jnp.asarray(w), col_scale=0.002,
                       activation="relu", out_dtype=jnp.int8, use_pallas=True,
                       interpret=True)
    t = TG.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                       col_scale=0.002, activation="relu", out_dtype=torch.int8)
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_int8_matmul_plain_is_exact_and_takes_ragged_shapes():
    x, w = _int8((3, 37), 5), _int8((100, 37), 6)
    out = TG.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(out.numpy(), (x.astype(np.int64) @ w.T.astype(np.int64)))
    with pytest.raises(TypeError):
        TG.int8_matmul(torch.zeros(2, 4), torch.from_numpy(w[:, :4]))
    with pytest.raises(ValueError):
        TG.int8_matmul(torch.from_numpy(x), torch.from_numpy(w[:, :5]))


# K1's main-path shapes: TinyLlama's K (q|k|v, o, gate|up: 2048; down: 5632)
# and OPT-6.7B's (q/k/v/o, fc1: 4096; fc2: 16384), with their N
_K1_SHAPES = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
              (4096, 4096), (4096, 16384), (16384, 4096)]


@pytest.mark.parametrize("m", [1, 8, 9, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("k", [2048, 5632, 4096, 16384])
def test_int8_route_is_chosen_by_shape(m, k):
    """K1's route depends on the shape and alignment only: the GEMV for
    M <= 8, and every main-path prefill shape (M > 8) takes the tensor-core
    route."""
    x = torch.zeros(m, k, dtype=torch.int8)
    w = torch.zeros(64, k, dtype=torch.int8)
    assert TG.route(m, k, x, w) == ("gemv" if m <= 8 else "tc")


@pytest.mark.parametrize("m,k", [(77, 70), (16, 40), (9, 2050)])
def test_int8_route_takes_tiles_for_ragged_k(m, k):
    x = torch.zeros(m, k, dtype=torch.int8)
    assert TG.route(m, k, x, torch.zeros(64, k, dtype=torch.int8)) == "tiles"


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("k,want", [(2048, "gemv"), (16, "gemv"), (2064, "gemv"),
                                    (70, "gemv_ragged"), (2056, "gemv_ragged"),
                                    (37, "gemv_ragged")])
def test_gemv_route_needs_16_byte_rows(m, k, want):
    """M <= 8 takes the GEMV where every row starts on 16 bytes (K % 16 ==
    0, aligned bases), the ragged GEMV otherwise; K1 and K4 alike."""
    for dt in (torch.int8, torch.float8_e4m3fn):
        x, w = torch.zeros(m, k).to(dt), torch.zeros(64, k).to(dt)
        assert TG.route(m, k, x, w) == want
        assert TF8.route(m, k, x, w) == want


def test_int8_route_takes_tiles_for_a_misaligned_view():
    """TMA needs 16-byte aligned bases; an offset view goes to the tiles,
    and at M <= 8 to the ragged GEMV."""
    buf = torch.zeros(130 * 2048 + 8, dtype=torch.int8)
    x = buf[8:].view(130, 2048)
    w = torch.zeros(64, 2048, dtype=torch.int8)
    assert x.is_contiguous() and TG.route(130, 2048, x, w) == "tiles"
    assert TG.route(130, 2048, buf[:-8].view(130, 2048), w) == "tc"
    assert TG.route(130, 2048, w.new_zeros(130, 2048), buf[8:8 + 64 * 2048].view(64, 2048)) \
        == "tiles"
    assert TG.route(4, 2048, buf[8:8 + 4 * 2048].view(4, 2048), w) == "gemv_ragged"
    assert TG.route(4, 2048, buf[16:16 + 4 * 2048].view(4, 2048), w) == "gemv"
    assert TG.route(4, 2048, w[:4], buf[8:8 + 64 * 2048].view(64, 2048)) == "gemv_ragged"


_GEMV_HEADER = (Path(TG.__file__).resolve().parents[1] / "csrc" / "asq_gemv.cuh").read_text()


def _gemv_constant(name):
    """A ``constexpr int`` of ``csrc/asq_gemv.cuh``: a product of numbers
    and of the constants defined before it."""
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([\w\s*]+);", _GEMV_HEADER):
        consts[key] = math.prod(int(f) if f.isdigit() else consts[f]
                                for f in (t.strip() for t in expr.split("*")))
    return consts[name]


@pytest.mark.parametrize("n", [1, 9, 15, 16, 17, 2048, 2560, 4104, 11264, 16384])
def test_gemv_blocks_cover_every_column_once(n):
    """ceil(N / 16) blocks of 16 weight rows: every column is one block's,
    and no block is empty."""
    blocks = TG.gemv_blocks(n)
    assert TG.GEMV_ROWS == _gemv_constant("kGemvRows")
    assert blocks * TG.GEMV_ROWS >= n > (blocks - 1) * TG.GEMV_ROWS


_SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory (a block may use 227 KB)


def test_gemv_ring_fits_four_blocks_an_sm():
    """The GEMV's shared memory does not depend on the shape: a ring of 4
    steps, each a 16-byte slot of x and of two weight rows for every
    thread (x is never held whole, so no M or K overflows it), and the
    warps' partial sums; with the 1 KB the card reserves a block, four
    blocks fit an SM, as ``__launch_bounds__(256, 4)`` asks, and a lane
    keeps all of its steps in flight up to K = 2048."""
    threads, warps = _gemv_constant("kGemvThreads"), _gemv_constant("kGemvWarps")
    ring = _gemv_constant("kGemvRingBytes")
    assert ring == _gemv_constant("kGemvStages") * 3 * threads * 16 == 48 * 1024
    partial_sums = warps * 32 * 4 * 4
    assert 4 * (ring + partial_sums + 1024) <= _SMEM_PER_SM
    in_flight = _gemv_constant("kGemvStages") * warps * _gemv_constant("kGemvStep")
    assert in_flight == 2048


@pytest.mark.parametrize("k,n", _K1_SHAPES)
def test_gemv_blocks_at_the_main_path_shapes(k, n):
    """Every main-path N is a multiple of 16: whole blocks, 128 (TinyLlama's
    o and down) to 1,024 (OPT-6.7B's fc1), so most grids are resident at
    once (four blocks an SM on 132 SMs)."""
    blocks = TG.gemv_blocks(n)
    assert blocks * 16 == n and 128 <= blocks <= 1024


@pytest.mark.parametrize("m", [9, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("k,n", _K1_SHAPES)
def test_int8_tc_split_fills_the_card_and_leaves_no_split_empty(m, k, n):
    """The tensor-core route's K splits: at least ~one block per SM where K
    allows it, every split non-empty, no split where the (M, N) tiles alone
    fill the SMs."""
    bm = 64 if m <= 64 else 128
    tiles = -(-m // bm) * -(-n // 64)
    k_tiles = -(-k // 128)
    split = TG.tc_split(m, n, k)
    per = -(-k_tiles // split)
    assert 1 <= split <= k_tiles and (split - 1) * per < k_tiles
    assert tiles * split >= min(128, tiles * k_tiles)
    assert split == 1 or tiles < 132


@pytest.mark.parametrize("t,d", [(256, 128), (16, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_add_rmsnorm_quant_matches_pallas(t, d, dtype):
    rng = np.random.default_rng(t + d)
    h = (rng.normal(size=(t, d)) * 3).astype(np.float32)
    x = rng.normal(size=(t, d)).astype(np.float32)
    g = (rng.random(d) * 40 + 10).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jh, jq = JF.fused_add_rmsnorm_quant(jnp.asarray(h, jdt), jnp.asarray(x, jdt),
                                        jnp.asarray(g), eps=1e-6, interpret=True)
    th, tq = TF.fused_add_rmsnorm_quant(torch.from_numpy(h).to(tdt),
                                        torch.from_numpy(x).to(tdt),
                                        torch.from_numpy(g), eps=1e-6)
    assert th.dtype == tdt and tq.dtype == torch.int8
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    dq = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3


def _qkv(b, t, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,t,hq,hkv,d", [(2, 128, 4, 2, 64), (1, 256, 8, 2, 128)])
def test_flash_attention_matches_pallas(b, t, hq, hkv, d):
    q, k, v = _qkv(b, t, t, hq, hkv, d, seed=t + d)
    scale = 1.0 / np.sqrt(d)
    j = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           sm_scale=scale, block_q=64, block_k=64, interpret=True)
    out = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pos,starts", [([0, 0, 0], [0, 5, 70]),
                                        ([0, 64, 128], [0, 10, 200])])
def test_flash_attention_banded_matches_pallas_on_valid_rows(pos, starts):
    b, t, s, hq, hkv, d = 3, 128, 256, 4, 2, 64
    q, k, v = _qkv(b, t, s, hq, hkv, d, seed=sum(pos) + sum(starts))
    scale = 1.0 / np.sqrt(d)
    pos_a, st_a = np.asarray(pos, np.int32), np.asarray(starts, np.int32)
    j = np.asarray(JA.flash_attention_banded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos_a),
        jnp.asarray(st_a), sm_scale=scale, block_q=64, block_k=64, interpret=True))
    out = TA.flash_attention_banded(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos_a), torch.from_numpy(st_a), sm_scale=scale).numpy()
    valid = (pos_a[:, None] + np.arange(t)[None, :]) >= st_a[:, None]
    assert (~valid).any()           # left-pad rows are part of the case
    np.testing.assert_allclose(out[valid], j[valid], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out[~valid], 0.0)


def test_flash_attention_causal_is_banded_with_zero_offsets():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 40, 4, 4, 64, seed=9))
    a = TA.flash_attention(q, k, v, sm_scale=0.125)
    bnd = TA.flash_attention_banded(q, k, v, 0, None, sm_scale=0.125)
    torch.testing.assert_close(a, bnd, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fp8 GEMM (K4's plain version) and int4 GEMM (K5's plain version, W4A16)
# ---------------------------------------------------------------------------

from autosmoothquant_tpu.kernels import fp8 as JF8            # noqa: E402
from autosmoothquant_tpu.kernels import int4 as JI4           # noqa: E402
from autosmoothquant_tpu.quant import math as JM              # noqa: E402
from autosmoothquant_tpu_torch.kernels import fp8 as TF8      # noqa: E402
from autosmoothquant_tpu_torch.kernels import int4 as TI4     # noqa: E402

_F8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _fp8_pair(m, k, n, fmt, seed, subnormals=True):
    """fp8 x [M, K] and w [K, N] (JAX layout) as numpy. With ``subnormals``
    the magnitudes spread over many decades, so both hold subnormal codes;
    without, every magnitude is at least the format's smallest normal."""
    jdt = _F8[fmt][0]
    tiny = float(jnp.finfo(jdt).smallest_normal)
    rng = np.random.default_rng(seed)

    def draw(shape):
        v = rng.normal(size=shape) * np.exp(rng.uniform(-12, 2, size=shape))
        if not subnormals:
            v = np.sign(v) * np.maximum(np.abs(v), tiny)
        return np.asarray(jnp.asarray(v.astype(np.float32)).astype(jdt))
    return draw((m, k)), draw((k, n))


def _t8(a, fmt):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy()).view(_F8[fmt][1])


def _acc_tol(x, w):
    """Every fp8 product is exact in f32, so only the sum order differs: the
    bound is K * 2**-24 * sum |x||w| per output."""
    mag = np.abs(x.astype(np.float32)) @ np.abs(w.astype(np.float32))
    return x.shape[1] * 2.0 ** -24 * mag


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,k,n", [(8, 512, 512), (64, 1024, 512)])
def test_fp8_matmul_plain_matches_stream_kernel(fmt, m, k, n):
    """Against the TPU kernel in interpret mode at shapes its tile picker
    takes (N a multiple of 512, K of 128, K >= 512, M <= 64); the scale
    epilogue JAX applies after the kernel is applied to its output here in
    the same order. Normal values only: the kernel's bit trick builds f32
    subnormals for fp8 subnormal codes, and XLA on the CPU flushes those to
    zero as the TPU does. Subnormals are held against the XLA path below."""
    x, w = _fp8_pair(m, k, n, fmt, seed=m + k, subnormals=False)
    acc = np.asarray(JF8.fp8_stream_matmul(jnp.asarray(x), jnp.asarray(w),
                                           interpret=True))
    rng = np.random.default_rng(k)
    rs = (rng.random((m, 1)) + 0.5).astype(np.float32)
    cs = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    want = acc * rs * cs + bias
    got = TF8.fp8_matmul(_t8(x, fmt), _t8(w.T, fmt), torch.from_numpy(rs),
                         torch.from_numpy(cs), torch.from_numpy(bias))
    tol = _acc_tol(x, w) * 2.0 * (rs * cs) + 1e-6
    assert (np.abs(got.numpy() - want) <= tol).all()
    raw = TF8.fp8_matmul_plain(_t8(x, fmt), _t8(w.T, fmt))
    assert (np.abs(raw.numpy() - acc) <= _acc_tol(x, w) + 1e-30).all()


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,k,n,scales", [(1, 100, 30, "scalar"), (5, 64, 72, "per_token"),
                                          (70, 200, 96, "col_vector")])
def test_fp8_matmul_matches_jax_xla_path(fmt, m, k, n, scales):
    """Shapes the stream kernel declines go through JAX's XLA fp8 dot."""
    x, w = _fp8_pair(m, k, n, fmt, seed=m + n)
    rng = np.random.default_rng(n)
    rs, cs = np.float32(0.37), np.float32(1.9)
    if scales == "per_token":
        rs = (rng.random((m, 1)) + 0.5).astype(np.float32)
    if scales == "col_vector":
        cs = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    for out_j, out_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        j = JG.fp8_matmul(jnp.asarray(x), jnp.asarray(w), row_scale=jnp.asarray(rs),
                          col_scale=jnp.asarray(cs), bias=jnp.asarray(bias),
                          out_dtype=out_j)
        t = TF8.fp8_matmul(_t8(x, fmt), _t8(w.T, fmt), torch.as_tensor(rs),
                           torch.as_tensor(cs), torch.from_numpy(bias), out_dtype=out_t)
        assert t.dtype == out_t
        want = np.asarray(j.astype(jnp.float32))
        tol = _acc_tol(x, w) * 2.0 * (np.abs(rs) * np.abs(cs)) + 1e-6
        if out_t == torch.bfloat16:
            tol = tol + np.abs(want) * 2.0 ** -8     # one bf16 rounding step
        assert (np.abs(t.float().numpy() - want) <= tol).all()


def test_fp8_matmul_checks_its_operands():
    x = torch.zeros(2, 16).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        TF8.fp8_matmul(x, torch.zeros(4, 16).to(torch.float8_e5m2))
    with pytest.raises(TypeError):
        TF8.fp8_matmul(torch.zeros(2, 16, dtype=torch.int8), torch.zeros(4, 16, dtype=torch.int8))
    with pytest.raises(ValueError):
        TF8.fp8_matmul(x, torch.zeros(4, 8).to(torch.float8_e4m3fn))


@pytest.mark.parametrize("m,k,want", [(1, 2048, "gemv"), (8, 5632, "gemv"), (9, 2048, "tc"),
                                      (128, 5632, "tc"), (512, 2048, "tc"), (20, 48, "tc"),
                                      (77, 70, "tiles"), (16, 40, "tiles"),
                                      (3, 37, "gemv_ragged"), (8, 2056, "gemv_ragged")])
def test_fp8_route_is_chosen_by_shape(m, k, want):
    """K4's route depends on the shape and alignment only: every main-path
    prefill shape (K 2048 / 5632, M > 8) takes the tensor-core route."""
    x = torch.zeros(m, k).to(torch.float8_e4m3fn)
    w = torch.zeros(64, k).to(torch.float8_e4m3fn)
    assert TF8.route(m, k, x, w) == want


def test_fp8_route_takes_tiles_for_a_misaligned_view():
    """TMA needs 16-byte aligned bases; an offset view goes to the tiles."""
    buf = torch.zeros(130 * 2048 + 8).to(torch.float8_e4m3fn)
    x = buf[8:].view(130, 2048)
    w = torch.zeros(64, 2048).to(torch.float8_e4m3fn)
    assert x.is_contiguous() and TF8.route(130, 2048, x, w) == "tiles"
    assert TF8.route(130, 2048, buf[:-8].view(130, 2048), w) == "tc"
    assert TF8.route(8, 2048, buf[8:8 + 8 * 2048].view(8, 2048), w) == "gemv_ragged"


@pytest.mark.parametrize("m", [9, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("k,n", [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048)])
def test_fp8_tc_split_fills_the_card_and_leaves_no_split_empty(m, k, n):
    """The tensor-core route's K splits (TinyLlama's projections): at least
    ~one block per SM where K allows it, every split non-empty, no split
    where the (M, N) tiles alone fill the SMs."""
    bm = 64 if m <= 64 else 128
    tiles = -(-m // bm) * -(-n // 64)
    k_tiles = -(-k // 128)
    split = TF8.tc_split(m, n, k)
    per = -(-k_tiles // split)
    assert 1 <= split <= k_tiles and (split - 1) * per < k_tiles
    assert tiles * split >= min(128, tiles * k_tiles)
    assert split == 1 or tiles < 132


def _int4_weights(k, n, group, seed):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    jp, js = JM.quantize_weight_int4_grouped(jnp.asarray(w), group)
    return jp, js, torch.from_numpy(np.asarray(jp).T.copy()), \
        torch.from_numpy(np.asarray(js).T.copy())


def _int4_x(m, k, seed):
    return (np.random.default_rng(seed).normal(size=(m, k)) * 2).astype(np.float32)


@pytest.mark.parametrize("m,k,n,group,hk", [(64, 768, 256, 128, 512),
                                            (16, 256, 128, 64, 64)])
def test_int4_matmul_matches_pallas_kernel(m, k, n, group, hk):
    """W4A8 (M <= 64) against the TPU kernel in interpret mode; K = 768 is
    stored at K' = 1024, and x keeps its 768 columns on the port's side.
    Tolerance: the group partials are exact in both; the f32 sum over groups
    runs in another order (rtol 1e-5)."""
    jp, js, tp, ts = _int4_weights(k, n, group, seed=k + n)
    x = _int4_x(m, k, seed=m)
    kp = 2 * jp.shape[0]
    xp = np.concatenate([x, np.zeros((m, kp - k), np.float32)], axis=1)
    tok = (np.maximum(np.abs(xp).max(-1, keepdims=True), 1e-8) / 127.0).astype(np.float32)
    j = np.asarray(JI4._int4_matmul_pallas(
        jnp.asarray(xp), jp[None], js[None], jnp.asarray(tok), 0, group=group,
        block_m=8, block_n=128, block_hk=hk, interpret=True, a8=True))
    t = TI4.int4_matmul(torch.from_numpy(x), tp, ts, out_dtype=torch.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("m", [64, 65])
@pytest.mark.parametrize("act", [None, "silu"])
def test_int4_matmul_routes_on_m_like_jax(m, act):
    """M = 64 takes W4A8 and M = 65 W4A16 in both packages (int4_matmul_xla
    on the JAX side, on the CPU); K = 768 stored as 1024. W4A16 is an f32
    product in both (rtol 1e-5, sums in another order)."""
    jp, js, tp, ts = _int4_weights(768, 128, 128, seed=3)
    x = _int4_x(m, 768, seed=4)
    bias = np.random.default_rng(5).normal(size=128).astype(np.float32)
    j = np.asarray(JI4.int4_matmul(jnp.asarray(x), jp, js, jnp.asarray(bias),
                                   activation=act, out_dtype=jnp.float32))
    t = TI4.int4_matmul(torch.from_numpy(x), tp, ts, torch.from_numpy(bias),
                        activation=act, out_dtype=torch.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
    # the route really differs: W4A8 quantizes x, W4A16 does not
    a8 = TI4.int4_matmul_plain(torch.from_numpy(x), tp, ts, torch.from_numpy(bias),
                               activation=act, out_dtype=torch.float32)
    a16 = TI4.int4_matmul_w4a16(torch.from_numpy(x), tp, ts, torch.from_numpy(bias),
                                activation=act, out_dtype=torch.float32)
    assert not torch.equal(a8, a16)
    torch.testing.assert_close(t, a8 if m <= 64 else a16, rtol=0, atol=0)


def test_int4_matmul_checks_its_operands():
    _, _, tp, ts = _int4_weights(256, 64, 128, seed=0)
    x = torch.zeros(2, 256)
    with pytest.raises(TypeError):
        TI4.int4_matmul(x, tp.to(torch.int8), ts)
    with pytest.raises(TypeError):
        TI4.int4_matmul(x.to(torch.int8), tp, ts)
    with pytest.raises(ValueError):
        TI4.int4_matmul(torch.zeros(2, 300), tp, ts)
    with pytest.raises(ValueError):
        TI4.int4_matmul(x, tp, ts[:5])


# K5's main-path shapes (K'/2, N): TinyLlama's q|k|v, o, gate|up and down
# (K' 2048, and 6144 for K = 5632), and an OPT-6.7B-sized q|k|v|o and fc2
_K5_SHAPES = [(1024, 2560), (1024, 2048), (1024, 11264), (3072, 2048), (2048, 4096),
              (8192, 4096)]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 33, 64, 65])
@pytest.mark.parametrize("group", [8, 64, 128])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int4_route_is_chosen_by_shape(m, group, xdt):
    """K5's route depends on the shape, x's dtype and alignment only: the
    GEMV for M <= 4 (f32 x) or M <= 2 (bf16), the CUDA-core columns for the
    rest of M <= 8, the tensor cores for 9 <= M <= 64 where each 32-byte mma
    step lies inside one group (group % 32 == 0), the columns for the other
    groups, W4A16 above 64 rows."""
    packed = torch.zeros(256, 1024, dtype=torch.uint8)
    gemv_max = {torch.float32: 4, torch.bfloat16: 2}[xdt]
    want = ("w4a16" if m > 64 else "gemv" if m <= gemv_max else "tiles" if m <= 8
            else "tc" if group % 32 == 0 else "tiles")
    assert TI4.route(m, 1024, group, xdt, packed) == want


def test_int4_route_takes_tiles_for_a_misaligned_view():
    """cp.async copies 16-byte chunks of the packed rows: an offset view goes
    to the CUDA-core columns, an aligned one to the tensor cores."""
    buf = torch.zeros(256 * 1024 + 8, dtype=torch.uint8)
    view = buf[8:].view(256, 1024)
    f32 = torch.float32
    assert view.is_contiguous() and TI4.route(33, 1024, 128, f32, view) == "tiles"
    assert TI4.route(33, 1024, 128, f32, buf[:-8].view(256, 1024)) == "tc"
    assert TI4.route(4, 1024, 128, f32, view) == "gemv"  # the GEMV takes any base


def test_int4_route_takes_tiles_where_the_halves_split_groups_apart():
    """The tensor cores close a group's two int32 partials together, at the
    low half's group boundaries: K'/2 must be a multiple of the group, or
    the high half's groups would end elsewhere. K' = 192 in G = 3 groups of
    64 (K'/2 = 96) goes to the columns; K' = 256 in 4 groups to the tensor
    cores."""
    packed = torch.zeros(64, 96, dtype=torch.uint8)
    assert TI4.route(33, 96, 64, torch.float32, packed) == "tiles"
    assert TI4.route(33, 128, 64, torch.float32, packed) == "tc"
    assert TI4.route(33, 96, 32, torch.float32, packed) == "tc"


def test_int4_gemv_needs_x_q_to_fit_in_shared_memory():
    """A GEMV block keeps x_q [M, K'] in shared memory: past 64 KB the
    shape goes to the CUDA-core columns."""
    packed = torch.zeros(64, 16, dtype=torch.uint8)
    f32 = torch.float32
    assert TI4.route(4, 8192, 128, f32, packed) == "gemv"       # 4 x 16384 = 64 KB
    assert TI4.route(4, 8320, 128, f32, packed) == "tiles"
    assert TI4.route(1, 8320, 128, f32, packed) == "gemv"
    assert TI4.route(2, 1023, 8, f32, packed) == "tiles"        # K' % 4 != 0


@pytest.mark.parametrize("m", [9, 16, 33, 64])
@pytest.mark.parametrize("k2,n", _K5_SHAPES)
def test_int4_tc_split_fills_the_card_and_leaves_no_split_empty(m, k2, n):
    """K5's tensor-core splits: one 64-row block covers all M <= 64, a K
    stage is 128 packed bytes; at least ~one block per SM where K allows it,
    every split non-empty, no split where the column tiles alone fill the
    SMs."""
    tiles = -(-n // 64)
    k_steps = -(-k2 // 128)
    split = TI4.tc_split(m, n, k2)
    per = -(-k_steps // split)
    assert 1 <= split <= k_steps and (split - 1) * per < k_steps
    assert tiles * split >= min(128, tiles * k_steps)
    assert split == 1 or tiles < 132


@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("banded", [False, True])
def test_flash_head_dim_padding_is_exact(d, banded):
    """K3 reads D = 80 and 96 as they lie into tiles zero past D up to its
    compute width (128), with the caller's sm_scale: plain attention on
    q/k/v zero-padded to 128, cut back to D, equals plain attention on the
    unpadded ones on valid rows. The wrapper's own padding (a D that is not
    a multiple of 8: d - 2 here, padded to d) is exact the same way."""
    b, t, s, hq, hkv = 3, 40, 96 if banded else 40, 8, 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, t, s, hq, hkv, d, seed=d))
    assert all(a is b for a, b in zip(TA._pad_head_dim(q, k, v), (q, k, v)))
    odd = tuple(x[..., :d - 2].contiguous() for x in (q, k, v))
    odd_padded = TA._pad_head_dim(*odd)
    assert all(x.shape[-1] == d and not x[..., d - 2:].any() for x in odd_padded)
    scale = d ** -0.5
    if banded:
        pos = torch.tensor([0, 20, 50], dtype=torch.int32)
        starts = torch.tensor([0, 9, 30], dtype=torch.int32)
        rows = (pos[:, None] + torch.arange(t)[None]) >= starts[:, None]

        def attend(*qkv):
            return TA.flash_attention_banded_plain(*qkv, pos, starts, sm_scale=scale)
    else:
        rows = torch.ones(b, t, dtype=torch.bool)

        def attend(*qkv):
            return TA.flash_attention_plain(*qkv, sm_scale=scale)
    for unpadded, padded in (((q, k, v), tuple(torch.nn.functional.pad(x, (0, 128 - d))
                                                   for x in (q, k, v))),
                             (odd, odd_padded)):
        dt = unpadded[0].shape[-1]
        ref, got = attend(*unpadded), attend(*padded)
        torch.testing.assert_close(got[..., :dt][rows], ref[rows], rtol=1e-6, atol=1e-6)
        assert not got[..., dt:].any()


def test_flash_head_dim_padding_keeps_the_built_dims_and_raises_past_128():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 64, seed=1))
    assert all(a is b for a, b in zip(TA._pad_head_dim(q, k, v), (q, k, v)))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 160, seed=1))
    with pytest.raises(ValueError):
        TA._pad_head_dim(q, k, v)


@pytest.mark.parametrize("d,want", [(2048, "vector"), (4096, "vector"), (12288, "vector"),
                                    (2056, "vector"), (4094, "rows"), (100, "rows"),
                                    (12296, "rows")])
def test_layernorm_route_is_chosen_by_shape(d, want):
    """K6 keeps the row in registers where D is a multiple of 8 (16-byte
    vectors) up to 12288; other D keep the shared-memory rows route."""
    h = torch.zeros(4, d)
    g = torch.zeros(d)
    assert TF.layernorm_route(d, h, h, g, g) == want


def test_layernorm_route_takes_rows_for_a_misaligned_view():
    buf = torch.zeros(4 * 2048 + 2, dtype=torch.bfloat16)
    h = buf[2:].view(4, 2048)
    g = torch.zeros(2048)
    assert h.is_contiguous() and TF.layernorm_route(2048, h, h, g, g) == "rows"
    assert TF.layernorm_route(2048, buf[:-2].view(4, 2048), h.contiguous(), g, g) == "rows"
    assert TF.layernorm_route(2048, h.clone(), h.clone(), g, g) == "vector"
