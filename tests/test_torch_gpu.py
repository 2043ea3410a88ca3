"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips (in the ``cuda_device`` fixture, at run time)
where there is no card. On a machine with one:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: int8_matmul exact (f32 rtol 1e-6, silu
1e-5, bf16 one rounding step); fused_add_rmsnorm_quant and
fused_add_layernorm_quant s equal, q within one step on <= 0.1% of
elements; flash attention on valid rows, f32 atol 2e-5,
bf16 atol 1.6e-2 + rtol 1e-2; a W8A8 model's logits, card against CPU, max
0.2 and mean 1e-2. fp8_matmul (K4) and int4_matmul (K5): the plain versions
sum exactly (float64), the kernels in f32, so the bound is twice the f32
sum's, 2 * K * 2**-24 * sum |x||w| per output (int4: over the exact 16-row
partials times their scales), plus one bf16 step (2**-7 of the value) for
bf16 outputs; K5's per-token quantization is bit-exact, so it adds
nothing (its tensor-core split adds f32 partials, within the same bound)."""

import math

import pytest
import torch

from autosmoothquant_tpu_torch.kernels import attention as A
from autosmoothquant_tpu_torch.kernels import fp8 as F8
from autosmoothquant_tpu_torch.kernels import fused as F
from autosmoothquant_tpu_torch.kernels import gemm as G
from autosmoothquant_tpu_torch.kernels import int4 as I4
from autosmoothquant_tpu_torch.quant import math as Q

from test_torch_util import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("m,k,n", [(1, 2048, 2560), (4, 5632, 2048),
                                   (128, 2048, 11264), (3, 37, 100), (77, 70, 130)])
@pytest.mark.parametrize("out", ["f32", "bf16", "int8"])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, k, n, out):
    g = _gen(m + k + n)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_device, generator=g)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda_device, generator=g)
    rs = torch.rand(m, 1, device=cuda_device, generator=g) + 0.5
    cs = (torch.rand(n, device=cuda_device, generator=g) + 0.5) / (64 * math.sqrt(k))
    bias = torch.randn(n, device=cuda_device, generator=g)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[out]
    act = "relu" if out == "int8" else None
    before = G.int8_matmul.launches
    got = G.int8_matmul(x, w, rs, cs, bias, activation=act, out_dtype=dt)
    ref = G.int8_matmul_plain(x, w, rs, cs, bias, activation=act, out_dtype=dt)
    torch.cuda.synchronize()
    assert G.int8_matmul.launches == before + 1
    rtol = {"f32": 1e-6, "bf16": 2.0 ** -8, "int8": 0.0}[out]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=0)


def test_int8_matmul_silu(cuda_device):
    g = _gen(1)
    x = torch.randint(-128, 128, (16, 512), dtype=torch.int8, device=cuda_device, generator=g)
    w = torch.randint(-127, 128, (256, 512), dtype=torch.int8, device=cuda_device, generator=g)
    got = G.int8_matmul(x, w, col_scale=1e-4, activation="silu")
    ref = G.int8_matmul_plain(x, w, col_scale=1e-4, activation="silu")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def _int8_case(m, k, n, device, seed):
    g = _gen(seed)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=device, generator=g)
    rs = torch.rand(m, 1, device=device, generator=g) + 0.5
    cs = (torch.rand(n, device=device, generator=g) + 0.5) / (64 * math.sqrt(k))
    bias = torch.randn(n, device=device, generator=g)
    return x, w, rs, cs, bias


def _tc_check(x, w, rs, cs, bias, act, dt):
    """One K1 call that must take the tensor-core route: f32 and int8
    outputs bit-equal to the plain version, bf16 within one rounding step,
    silu within its tolerance."""
    m, k = x.shape
    assert G.route(m, k, x, w) == "tc"
    before, tc_before = G.int8_matmul.launches, G.int8_matmul.tc_launches
    got = G.int8_matmul(x, w, rs, cs, bias, activation=act, out_dtype=dt)
    ref = G.int8_matmul_plain(x, w, rs, cs, bias, activation=act, out_dtype=dt)
    torch.cuda.synchronize()
    assert G.int8_matmul.launches == before + 1
    assert G.int8_matmul.tc_launches == tc_before + 1 and got.dtype == dt
    if act == "silu":
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-5, atol=1e-6)
    elif dt == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -8, atol=0)
    else:
        assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("m", [9, 63, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("k,n", [(2048, 2560), (5632, 2048), (16384, 4096)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16, torch.int8])
def test_int8_matmul_tensor_core_route(cuda_device, m, k, n, out):
    """Every M > 8 with K % 16 == 0 takes K1's tensor-core route (TMA, int8
    wgmma): one or two consumer warpgroups, split K or not, rows past M
    masked; per-token and column-vector scales and a bias."""
    x, w, rs, cs, bias = _int8_case(m, k, n, cuda_device, m + k + n)
    if out == torch.int8:
        cs = cs * 40  # outputs spread over the int8 range
    _tc_check(x, w, rs, cs, bias, "relu" if out == torch.int8 else None, out)


@pytest.mark.parametrize("m", [9, 65, 128, 512])
@pytest.mark.parametrize("act", ["silu", "relu"])
def test_int8_matmul_tensor_core_route_activations(cuda_device, m, act):
    x, w, rs, cs, bias = _int8_case(m, 5632, 2048, cuda_device, m)
    _tc_check(x, w, rs, cs, bias, act, torch.float32)


@pytest.mark.parametrize("m,k,n", [(128, 16384, 4096), (129, 5632, 2048), (9, 2048, 2560),
                                   (512, 2048, 2048)])
def test_int8_matmul_split_k_gives_the_unsplit_bits(cuda_device, m, k, n):
    """The int32 partial sums of a split K add exactly: the same product
    forced to one split has the same bits."""
    from autosmoothquant_tpu_torch.kernels import _build

    x, w, rs, cs, bias = _int8_case(m, k, n, cuda_device, 7)
    split = G.tc_split(m, n, k)
    assert split > 1
    got = _tc_check(x, w, rs, cs, bias, None, torch.float32)
    one = torch.empty_like(got)
    fn = _build.function("int8_gemm", "asq_int8_gemm_tc", G._TC_ARGTYPES)
    rc = fn(x.data_ptr(), w.data_ptr(), rs.data_ptr(), 1, cs.data_ptr(), 1, bias.data_ptr(),
            one.data_ptr(), m, n, k, 0, 0, 1, None, _build.stream_ptr(x))
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(got, one)


def test_int8_matmul_misaligned_view_takes_the_tiles(cuda_device):
    """TMA needs 16-byte aligned bases: an offset view of x or of w goes to
    the CUDA-core tiles, with the plain version's bits."""
    x, w, rs, cs, bias = _int8_case(130, 2048, 256, cuda_device, 11)
    buf = torch.empty(130 * 2048 + 8, dtype=torch.int8, device=cuda_device)
    xv = buf[8:].view(130, 2048).copy_(x)
    wbuf = torch.empty(256 * 2048 + 8, dtype=torch.int8, device=cuda_device)
    wv = wbuf[8:].view(256, 2048).copy_(w)
    for xa, wa in ((xv, w), (x, wv)):
        assert G.route(130, 2048, xa, wa) == "tiles"
        before, tc_before = G.int8_matmul.launches, G.int8_matmul.tc_launches
        got = G.int8_matmul(xa, wa, rs, cs, bias)
        torch.cuda.synchronize()
        assert G.int8_matmul.launches == before + 1 and G.int8_matmul.tc_launches == tc_before
        assert torch.equal(got, G.int8_matmul_plain(x, w, rs, cs, bias))


@pytest.mark.parametrize("t", [1, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_add_rmsnorm_quant_kernel_matches_plain(cuda_device, t, dtype):
    g = _gen(t)
    h = (torch.randn(t, 2048, device=cuda_device, generator=g) * 2).to(dtype)
    x = torch.randn(t, 2048, device=cuda_device, generator=g).to(dtype)
    gamma = 32 * (1 + 0.1 * torch.randn(2048, device=cuda_device, generator=g))
    s, q = F.fused_add_rmsnorm_quant(h, x, gamma, eps=1e-5)
    s_ref, q_ref = F.fused_add_rmsnorm_quant_plain(h, x, gamma, eps=1e-5)
    assert torch.equal(s, s_ref)
    dq = (q.int() - q_ref.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 128)])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, d):
    g = _gen(d)
    q = torch.randn(2, 200, 32, d, device=cuda_device, generator=g).to(dtype)
    k = torch.randn(2, 200, 4, d, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(2, 200, 4, d, device=cuda_device, generator=g).to(dtype)
    got = A.flash_attention(q, k, v, sm_scale=d ** -0.5)
    ref = A.flash_attention_plain(q, k, v, sm_scale=d ** -0.5)
    atol, rtol = (1.6e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (16, 4), (32, 4)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_tensor_core_route(cuda_device, t, hq, hkv, d):
    """K3's bf16 route (mma.sync, P rounded to bf16 before P V) at T not a
    multiple of its 64-row and 64-key tiles, G = Hq / Hkv in {1, 4, 8};
    the bf16 tolerance as above."""
    g = _gen(t + hq + d)
    q = torch.randn(2, t, hq, d, device=cuda_device, generator=g).to(torch.bfloat16)
    k = torch.randn(2, t, hkv, d, device=cuda_device, generator=g).to(torch.bfloat16)
    v = torch.randn(2, t, hkv, d, device=cuda_device, generator=g).to(torch.bfloat16)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, sm_scale=d ** -0.5)
    ref = A.flash_attention_plain(q, k, v, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2, atol=1.6e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_banded_bf16_fully_masked_rows_are_zero(cuda_device, d):
    """Rows whose band is empty (pos_b + i < starts_b: the left padding of a
    ragged prefill) come out 0 on the tensor-core route; the others match."""
    g = _gen(d + 1)
    q = torch.randn(3, 100, 16, d, device=cuda_device, generator=g).to(torch.bfloat16)
    k = torch.randn(3, 300, 4, d, device=cuda_device, generator=g).to(torch.bfloat16)
    v = torch.randn(3, 300, 4, d, device=cuda_device, generator=g).to(torch.bfloat16)
    pos = torch.tensor([0, 3, 150], dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([70, 40, 120], dtype=torch.int32, device=cuda_device)
    got = A.flash_attention_banded(q, k, v, pos, starts, sm_scale=d ** -0.5)
    ref = A.flash_attention_banded_plain(q, k, v, pos, starts, sm_scale=d ** -0.5)
    rows = (pos[:, None] + torch.arange(100, device=cuda_device)[None]) >= starts[:, None]
    assert int((~rows).sum()) == 70 + 37
    torch.testing.assert_close(got[rows].float(), ref[rows].float(), rtol=1e-2, atol=1.6e-2)
    assert torch.count_nonzero(got[~rows]) == 0


def test_flash_attention_banded_kernel_matches_plain(cuda_device):
    g = _gen(7)
    q = torch.randn(4, 128, 32, 64, device=cuda_device, generator=g).to(torch.bfloat16)
    k = torch.randn(4, 512, 4, 64, device=cuda_device, generator=g).to(torch.bfloat16)
    v = torch.randn(4, 512, 4, 64, device=cuda_device, generator=g).to(torch.bfloat16)
    pos = torch.tensor([0, 100, 256, 0], dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([0, 10, 0, 95], dtype=torch.int32, device=cuda_device)
    got = A.flash_attention_banded(q, k, v, pos, starts, sm_scale=0.125)
    ref = A.flash_attention_banded_plain(q, k, v, pos, starts, sm_scale=0.125)
    rows = (pos[:, None] + torch.arange(128, device=cuda_device)[None]) >= starts[:, None]
    torch.testing.assert_close(got[rows].float(), ref[rows].float(), rtol=1e-2, atol=1.6e-2)
    assert torch.count_nonzero(got[~rows]) == 0


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_w8a8_forward_on_the_card_matches_the_cpu(cuda_device, kv_dtype):
    """A 2-layer W8A8 model (chip_smoke.py's random int8 weights) on the card
    against the CPU with the same weights, f32 compute: ragged prefill
    (banded flash over the cache) and one decode step over it, with an f32
    or an int8 KV cache. Valid-row logits (std ~2) within max 0.2 and mean
    1e-2, chip_smoke.py's e2e tolerance: a last-bit difference may move an
    activation across an int8 rounding boundary."""
    import chip_smoke
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    cfg = L.LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2)
    qcfg = QuantConfig(type="int8")
    params = L.fuse_decode_projections(chip_smoke.draw_w8a8(cfg, seed=1, device="cpu"))
    b, t, s_max = 3, 24, 64
    ids = torch.randint(0, cfg.vocab_size, (b, t), generator=torch.Generator().manual_seed(2))
    pads = torch.tensor([0, 5, 13], dtype=torch.int32)
    positions = torch.clamp(torch.arange(t)[None, :] - pads[:, None], min=0)
    col = torch.arange(s_max)[None, :]
    kv_valid = (col >= pads[:, None]) & (col <= t)
    valid_rows = torch.arange(t)[None, :] >= pads[:, None]
    out, tok = {}, None
    for dev in ("cpu", cuda_device):
        p = chip_smoke.to_device(params, dev)
        cache = L.init_kv_cache(cfg, b, s_max, kv_dtype, dev)
        with torch.inference_mode():
            h, _ = L.forward(p, ids.to(dev), cfg, qcfg, kv_cache=cache, cache_index=0,
                             pad_starts=pads.to(dev), positions=positions.to(dev))
            pre = L.logits(p, h).cpu()
            if tok is None:
                tok = pre[:, -1].argmax(-1)
            h, _ = L.forward(p, tok[:, None].to(dev), cfg, qcfg, kv_cache=cache,
                             cache_index=t, kv_valid=kv_valid.to(dev),
                             positions=(t - pads)[:, None].to(dev))
            out[str(dev)] = (pre[valid_rows], L.logits(p, h)[:, 0].cpu())
    for cpu, card in zip(out["cpu"], out[str(cuda_device)]):
        diff = (card - cpu).abs()
        assert float(diff.max()) <= 0.2 and float(diff.mean()) <= 1e-2, (
            float(diff.max()), float(diff.mean()))


def _fp8_operands(m, k, n, dtype, device, g):
    """fp8 x [M, K] and w [N, K] spread over many decades (subnormals
    included), through the port's own quantizers."""
    def draw(shape):
        v = torch.randn(shape, device=device, generator=g)
        return v * torch.exp(torch.empty(shape, device=device).uniform_(-8, 2, generator=g))
    if dtype == torch.float8_e5m2:
        return draw((m, k)).to(dtype), draw((n, k)).to(dtype)
    x, _ = Q.quantize_fp8_per_tensor(draw((m, k)), dtype)
    w, _ = Q.quantize_fp8_per_tensor(draw((n, k)), dtype)
    return x, w


def _sum_bound(x, w):
    return x.shape[1] * 2.0 ** -24 * (x.double().abs() @ w.double().abs().t())


def _check_fp8(m, k, n, fmt, out, device):
    g = _gen(m + k + n)
    x, w = _fp8_operands(m, k, n, fmt, device, g)
    rs = torch.rand(m, 1, device=device, generator=g) + 0.5
    cs = torch.rand(n, device=device, generator=g) + 0.5
    bias = torch.randn(n, device=device, generator=g)
    tc = F8.route(m, k, x, w) == "tc"
    before, tc_before = F8.fp8_matmul.launches, F8.fp8_matmul.tc_launches
    got = F8.fp8_matmul(x, w, rs, cs, bias, out_dtype=out)
    ref = F8.fp8_matmul_plain(x, w, rs, cs, bias, out_dtype=out)
    torch.cuda.synchronize()
    assert F8.fp8_matmul.launches == before + 1 and got.dtype == out
    assert F8.fp8_matmul.tc_launches == tc_before + int(tc)
    tol = _sum_bound(x, w) * 2 * (rs.double() * cs.double()) + 1e-6
    if out == torch.bfloat16:
        tol = tol + ref.double().abs() * 2.0 ** -7
    assert bool(((got.double() - ref.double()).abs() <= tol).all())
    return tc


@pytest.mark.parametrize("m,k,n", [(1, 2048, 2560), (4, 5632, 2048), (8, 2048, 11264),
                                   (128, 2048, 2048), (3, 37, 100), (77, 70, 130)])
@pytest.mark.parametrize("fmt", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_fp8_matmul_kernel_matches_plain(cuda_device, m, k, n, fmt, out):
    _check_fp8(m, k, n, fmt, out, cuda_device)


@pytest.mark.parametrize("m", [9, 63, 64, 65, 128, 129, 512])
@pytest.mark.parametrize("k,n", [(2048, 2560), (5632, 2048)])
@pytest.mark.parametrize("fmt", [torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_fp8_matmul_tensor_core_route(cuda_device, m, k, n, fmt, out):
    """Every M > 8 with K % 16 == 0 takes the tensor-core route (TMA, the
    fp8 tiles converted to f16 for wgmma): one or two consumer warpgroups,
    split K (qkv, down) or not, rows past M masked."""
    assert _check_fp8(m, k, n, fmt, out, cuda_device)


def test_fp8_matmul_scalar_scales_and_e5m2_without_scales(cuda_device):
    g = _gen(3)
    x, w = _fp8_operands(4, 2048, 2048, torch.float8_e4m3fn, cuda_device, g)
    got = F8.fp8_matmul(x, w, torch.tensor(0.25, device=cuda_device),
                        torch.tensor(0.5, device=cuda_device))
    ref = F8.fp8_matmul_plain(x, w, torch.tensor(0.25, device=cuda_device),
                              torch.tensor(0.5, device=cuda_device))
    assert bool(((got.double() - ref.double()).abs()
                 <= _sum_bound(x, w) * 0.25 + 1e-6).all())
    x5, w5 = _fp8_operands(1, 2048, 256, torch.float8_e5m2, cuda_device, g)
    got = F8.fp8_matmul(x5, w5)
    ref = F8.fp8_matmul_plain(x5, w5)
    assert bool(((got.double() - ref.double()).abs() <= _sum_bound(x5, w5) + 1e-6).all())


def test_fp8_matmul_raises_on_wrong_dtype_or_device(cuda_device):
    x = torch.zeros(2, 64, device=cuda_device).to(torch.float8_e4m3fn)
    w = torch.zeros(8, 64, device=cuda_device).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        F8.fp8_matmul(x, w.to(torch.float8_e5m2))
    with pytest.raises(ValueError):
        F8.fp8_matmul(x, w.cpu())
    with pytest.raises(ValueError):
        F8.fp8_matmul(x, w, out_dtype=torch.int8)


# K1's and K4's GEMV (M <= 8): the main-path shapes, TinyLlama-1.1B's four
# projections and OPT-6.7B's three, as (K, N)
_GEMV_SHAPES = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
                (4096, 4096), (4096, 16384), (16384, 4096)]
# (out dtype, activation, per-token scale, bias), in rotation
_GEMV_EPILOGUES = [(torch.float32, None, True, True), (torch.bfloat16, None, False, False),
                   (torch.int8, "relu", False, False), (torch.float32, "silu", True, True),
                   (torch.bfloat16, "relu", True, True), (torch.int8, None, True, True)]


def _gemv_int8_check(x, w, rs, cs, bias, act, dt, want="gemv"):
    """One K1 call that must take route ``want``: f32 and int8 outputs
    bit-equal to the plain version, bf16 within one rounding step, silu
    within its tolerance (the int32 sums are exact on every route)."""
    m, k = x.shape
    assert G.route(m, k, x, w) == want
    before, gemv_before = G.int8_matmul.launches, G.int8_matmul.gemv_launches
    got = G.int8_matmul(x, w, rs, cs, bias, activation=act, out_dtype=dt)
    ref = G.int8_matmul_plain(x.contiguous(), w.contiguous(), rs, cs, bias, activation=act,
                              out_dtype=dt)
    torch.cuda.synchronize()
    assert G.int8_matmul.launches == before + 1 and got.dtype == dt
    assert G.int8_matmul.gemv_launches == gemv_before + int(want == "gemv")
    if act == "silu":
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-5, atol=1e-6)
    elif dt == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -8, atol=0)
    else:
        assert torch.equal(got, ref)
    return got


def _gemv_epilogue_case(m, k, n, device, i):
    dt, act, per_row, has_bias = _GEMV_EPILOGUES[i % len(_GEMV_EPILOGUES)]
    x, w, rs, cs, bias = _int8_case(m, k, n, device, 100 * m + i)
    if dt == torch.int8:
        cs = cs * 40  # outputs spread over the int8 range
    return x, w, rs if per_row else 1.0, cs, bias if has_bias else None, act, dt


@pytest.mark.parametrize("m", list(range(1, 9)))
@pytest.mark.parametrize("shape", range(len(_GEMV_SHAPES)))
def test_int8_gemv_every_m_at_main_path_shapes(cuda_device, m, shape):
    """K1's GEMV at every M <= 8 (a wrong fragment mapping passes at M=1)
    and every main-path shape, epilogues in rotation: the plain version's
    bits."""
    k, n = _GEMV_SHAPES[shape]
    _gemv_int8_check(*_gemv_epilogue_case(m, k, n, cuda_device, m + shape))


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("i", range(len(_GEMV_EPILOGUES)))
def test_int8_gemv_epilogues(cuda_device, m, i):
    """f32, bf16 and int8 out; no activation, relu, silu; bias and
    per-token scales or neither."""
    _gemv_int8_check(*_gemv_epilogue_case(m, 2048, 2560, cuda_device, i))


@pytest.mark.parametrize("m,k,n,want", [
    (3, 2064, 100, "gemv"),      # K % 64 != 0: a last step of one chunk a lane; N % 8 != 0
    (8, 48, 37, "gemv"),         # one step: seven warps hold nothing
    (1, 16, 1, "gemv"),
    (5, 4096, 4104, "gemv"),     # a last block of 8 rows
    (3, 37, 100, "gemv_ragged"),  # K % 16 != 0
    (8, 2056, 130, "gemv_ragged")])
def test_int8_gemv_edges(cuda_device, m, k, n, want):
    x, w, rs, cs, bias = _int8_case(m, k, n, cuda_device, k + n)
    _gemv_int8_check(x, w, rs, cs, bias, None, torch.float32, want)


def test_int8_gemv_offset_views(cuda_device):
    """An 8-byte offset view of x or of w takes the ragged GEMV; a 16-byte
    offset view is aligned and takes the GEMV. The plain version's bits."""
    x, w, rs, cs, bias = _int8_case(4, 2048, 2560, cuda_device, 3)
    for off, want in ((8, "gemv_ragged"), (16, "gemv")):
        buf = torch.empty(x.numel() + off, dtype=torch.int8, device=cuda_device)
        xv = buf[off:].view(4, 2048).copy_(x)
        _gemv_int8_check(xv, w, rs, cs, bias, None, torch.float32, want)
        buf = torch.empty(w.numel() + off, dtype=torch.int8, device=cuda_device)
        wv = buf[off:].view(2560, 2048).copy_(w)
        _gemv_int8_check(x, wv, rs, cs, bias, None, torch.float32, want)


def _gemv_fp8_check(x, w, rs, cs, bias, out, want="gemv"):
    """One K4 call that must take route ``want``, within the f32 sum's
    bound of the exact (float64) plain version."""
    m, k = x.shape
    assert F8.route(m, k, x, w) == want
    before, gemv_before = F8.fp8_matmul.launches, F8.fp8_matmul.gemv_launches
    got = F8.fp8_matmul(x, w, rs, cs, bias, out_dtype=out)
    ref = F8.fp8_matmul_plain(x, w, rs, cs, bias, out_dtype=out)
    torch.cuda.synchronize()
    assert F8.fp8_matmul.launches == before + 1 and got.dtype == out
    assert F8.fp8_matmul.gemv_launches == gemv_before + int(want == "gemv")
    scale = torch.as_tensor(rs, device=x.device).double().abs() * torch.as_tensor(
        cs, device=x.device).double().abs()
    tol = _sum_bound(x, w) * 2 * scale + 1e-6
    if out == torch.bfloat16:
        tol = tol + ref.double().abs() * 2.0 ** -7
    assert bool(((got.double() - ref.double()).abs() <= tol).all())
    return got


@pytest.mark.parametrize("m", list(range(1, 9)))
@pytest.mark.parametrize("shape", range(len(_GEMV_SHAPES)))
@pytest.mark.parametrize("fmt", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_gemv_every_m_at_main_path_shapes(cuda_device, m, shape, fmt):
    """K4's GEMV at every M <= 8 and every main-path shape, on operands
    spread over ten e-folds of magnitude (subnormals included), per-token
    and per-column scales, a bias, f32 or bf16 out in rotation."""
    k, n = _GEMV_SHAPES[shape]
    g = _gen(m + 10 * shape)
    x, w = _fp8_operands(m, k, n, fmt, cuda_device, g)
    rs = torch.rand(m, 1, device=cuda_device, generator=g) + 0.5
    cs = torch.rand(n, device=cuda_device, generator=g) + 0.5
    bias = torch.randn(n, device=cuda_device, generator=g)
    out = (torch.float32, torch.bfloat16)[(m + shape) % 2]
    _gemv_fp8_check(x, w, rs, cs, bias, out)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("fmt", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_gemv_ten_decade_operands_unit_scales(cuda_device, m, fmt):
    """Unit scales and f32 out, where the accumulation's rounding shows
    most: within the f32 sum's bound at TinyLlama's down_proj (K = 5632)."""
    g = _gen(m)
    x, w = _fp8_operands(m, 5632, 2048, fmt, cuda_device, g)
    _gemv_fp8_check(x, w, 1.0, 1.0, None, torch.float32)


@pytest.mark.parametrize("m,k,n,want", [(3, 2064, 100, "gemv"), (8, 48, 37, "gemv"),
                                        (5, 4096, 4104, "gemv"), (3, 37, 100, "gemv_ragged"),
                                        (8, 2056, 130, "gemv_ragged")])
def test_fp8_gemv_edges(cuda_device, m, k, n, want):
    g = _gen(k + n)
    x, w = _fp8_operands(m, k, n, torch.float8_e4m3fn, cuda_device, g)
    _gemv_fp8_check(x, w, 0.5, 0.25, None, torch.float32, want)


def test_fp8_gemv_offset_view_takes_the_ragged_gemv(cuda_device):
    g = _gen(5)
    x, w = _fp8_operands(4, 2048, 2048, torch.float8_e5m2, cuda_device, g)
    buf = torch.empty(x.numel() + 8, dtype=torch.uint8, device=cuda_device)
    xv = buf[8:].view(torch.float8_e5m2).view(4, 2048)
    xv.copy_(x)
    _gemv_fp8_check(xv, w, 1.0, 1.0, None, torch.float32, "gemv_ragged")


@pytest.mark.parametrize("k,n", [(5632, 2048), (16384, 4096)])
def test_gemv_gives_the_same_bits_every_call(cuda_device, k, n):
    """No atomics: K4's f32 sums (and K1's) are added in a fixed order, so
    two calls give equal bits."""
    g = _gen(k)
    x, w = _fp8_operands(8, k, n, torch.float8_e4m3fn, cuda_device, g)
    first = _gemv_fp8_check(x, w, 1.0, 1.0, None, torch.float32)
    assert torch.equal(first, _gemv_fp8_check(x, w, 1.0, 1.0, None, torch.float32))
    xi, wi, rs, cs, bias = _int8_case(8, k, n, cuda_device, n)
    first = _gemv_int8_check(xi, wi, rs, cs, bias, None, torch.float32)
    assert torch.equal(first, _gemv_int8_check(xi, wi, rs, cs, bias, None, torch.float32))


def _int4_operands(k, n, group, device, g):
    w = torch.randn(k, n, device=device, generator=g)
    packed, scales = Q.quantize_weight_int4_grouped(w, group)
    return packed.t().contiguous(), scales.t().contiguous()


@pytest.mark.parametrize("m,k,n,group", [(1, 2048, 2560, 128), (4, 5632, 2048, 128),
                                         (64, 2048, 11264, 128), (9, 768, 256, 128),
                                         (3, 512, 96, 64), (5, 96, 40, 8)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int4_matmul_kernel_matches_plain(cuda_device, m, k, n, group, xdt):
    """K5 at TinyLlama shapes (down_proj stored at K' = 6144 for K = 5632),
    a padded K = 768 -> 1024, and a group of 8 (the byte-wise loop)."""
    g = _gen(m + k + n)
    packed, scales = _int4_operands(k, n, group, cuda_device, g)
    x = (torch.randn(m, k, device=cuda_device, generator=g) * 3).to(xdt)
    bias = torch.randn(n, device=cuda_device, generator=g)
    for act, out in ((None, xdt), ("silu", torch.float32)):
        before = I4.int4_matmul.launches
        got = I4.int4_matmul(x, packed, scales, bias, activation=act, out_dtype=out)
        ref = I4.int4_matmul_plain(x, packed, scales, bias, activation=act, out_dtype=out)
        torch.cuda.synchronize()
        assert I4.int4_matmul.launches == before + 1 and got.dtype == out
        # |partial| * scale summed over chunks, times tok_scale: the f32 sum's bound
        q, ts = Q.quantize_act_per_token(torch.nn.functional.pad(
            x.float(), (0, 2 * packed.shape[1] - k)))
        wq = torch.cat(Q.unpack_int4(packed), dim=1).double()
        srep = scales.double().repeat_interleave(2 * packed.shape[1] // scales.shape[1], 1)
        mag = (q.double().abs() @ (wq.abs() * srep).t()) * ts.double()
        tol = k * 2.0 ** -24 * mag * 2 + 1e-6
        if out == torch.bfloat16:
            tol = tol + ref.double().abs() * 2.0 ** -7
        assert bool(((got.double() - ref.double()).abs() <= tol).all()), act


# TinyLlama's int4 projections (K, N): q|k|v, o, gate|up, down (K' 6144)
_K5_SHAPES = [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048)]


def _int4_tol(x, packed, scales, ref, out):
    """The f32 sum's bound over exact group partials (module docstring)."""
    k = x.shape[1]
    q, ts = Q.quantize_act_per_token(torch.nn.functional.pad(
        x.float(), (0, 2 * packed.shape[1] - k)))
    wq = torch.cat(Q.unpack_int4(packed), dim=1).double()
    srep = scales.double().repeat_interleave(2 * packed.shape[1] // scales.shape[1], 1)
    mag = (q.double().abs() @ (wq.abs() * srep).t()) * ts.double()
    tol = 2 * packed.shape[1] * 2.0 ** -24 * mag * 2 + 1e-6
    if out == torch.bfloat16:
        tol = tol + ref.double().abs() * 2.0 ** -7
    return tol


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9, 16, 33, 63, 64])
@pytest.mark.parametrize("k,n", _K5_SHAPES)
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int4_matmul_routes_at_tinyllama_shapes(cuda_device, m, k, n, xdt):
    """K5's one-launch GEMV (M <= 4 for f32 x, 2 for bf16), its CUDA-core
    columns (the rest of M <= 8) and its tensor-core route (9 <= M <= 64,
    counted in tc_launches; split K on q|k|v, o and down) at the main path's
    shapes: out in x's dtype with a bias, and f32 with silu, each within the
    f32 sum's bound."""
    g = _gen(m + k + n)
    packed, scales = _int4_operands(k, n, 128, cuda_device, g)
    x = (torch.randn(m, k, device=cuda_device, generator=g) * 3).to(xdt)
    bias = torch.randn(n, device=cuda_device, generator=g)
    how = I4.route(m, packed.shape[1], 128, xdt, packed)
    assert how == ("gemv" if m <= I4.GEMV_MAX_M[xdt] else "tiles" if m <= 8 else "tc")
    for act, out in ((None, xdt), ("silu", torch.float32), (None, torch.bfloat16)):
        before, tc_before = I4.int4_matmul.launches, I4.int4_matmul.tc_launches
        got = I4.int4_matmul(x, packed, scales, bias, activation=act, out_dtype=out)
        ref = I4.int4_matmul_plain(x, packed, scales, bias, activation=act, out_dtype=out)
        torch.cuda.synchronize()
        assert I4.int4_matmul.launches == before + 1 and got.dtype == out
        assert I4.int4_matmul.tc_launches == tc_before + int(how == "tc")
        tol = _int4_tol(x, packed, scales, ref, out)
        assert bool(((got.double() - ref.double()).abs() <= tol).all()), (act, out)


def test_int4_matmul_odd_group_count_takes_the_columns(cuda_device):
    """K' = 192 in G = 3 groups of 64 (K'/2 = 96 is no multiple of the
    group): the route is "tiles", which agrees with the plain version, and
    the tensor-core entry point refuses the shape."""
    g = _gen(192)
    packed = torch.randint(0, 256, (128, 96), device=cuda_device, generator=g).to(torch.uint8)
    scales = torch.rand(128, 3, device=cuda_device, generator=g) + 0.01
    x = torch.randn(33, 192, device=cuda_device, generator=g)
    assert I4.route(33, 96, 64, x.dtype, packed) == "tiles"
    before, tc_before = I4.int4_matmul.launches, I4.int4_matmul.tc_launches
    got = I4.int4_matmul(x, packed, scales, out_dtype=torch.float32)
    ref = I4.int4_matmul_plain(x, packed, scales, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert I4.int4_matmul.launches == before + 1 and I4.int4_matmul.tc_launches == tc_before
    tol = _int4_tol(x, packed, scales, ref, torch.float32)
    assert bool(((got.double() - ref.double()).abs() <= tol).all())
    from autosmoothquant_tpu_torch.kernels import _build

    fn = _build.function("int4_gemm", "asq_int4_gemm_tc", I4._TC_ARGTYPES)
    xq = torch.empty(33, 192, dtype=torch.int8, device=cuda_device)
    ts = torch.empty(33, device=cuda_device)
    rc = fn(x.data_ptr(), 0, packed.data_ptr(), scales.data_ptr(), None, got.data_ptr(),
            xq.data_ptr(), ts.data_ptr(), 33, 128, 192, 96, 3, 0, 0, 1, None,
            _build.stream_ptr(x))
    assert rc != 0


def _int4_tc_raw(x, packed, scales, split):
    """One call of K5's tensor-core entry point with its scratch returned:
    (out f32, x_q, tok_scale)."""
    from autosmoothquant_tpu_torch.kernels import _build

    m, k = x.shape
    n, k2 = packed.shape
    out = torch.empty(m, n, device=x.device)
    xq = torch.empty(m, 2 * k2, dtype=torch.int8, device=x.device)
    ts = torch.empty(m, device=x.device)
    ws = torch.empty(split * m * n, device=x.device) if split > 1 else None
    fn = _build.function("int4_gemm", "asq_int4_gemm_tc", I4._TC_ARGTYPES)
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(), scales.data_ptr(),
            None, out.data_ptr(), xq.data_ptr(), ts.data_ptr(), m, n, k, k2, scales.shape[1],
            0, 0, split, _build.ptr(ws), _build.stream_ptr(x))
    torch.cuda.synchronize()
    assert rc == 0
    return out, xq, ts


@pytest.mark.parametrize("m,k,n", [(33, 2048, 2560), (64, 5632, 2048), (16, 2048, 2048)])
def test_int4_tc_split_agrees_with_one_split(cuda_device, m, k, n):
    """Split K adds f32 partials in a fixed order: the same product forced to
    one split agrees within the f32 sum's bound, and a repeat of the split
    product has the same bits."""
    g = _gen(m + n)
    packed, scales = _int4_operands(k, n, 128, cuda_device, g)
    x = torch.randn(m, k, device=cuda_device, generator=g)
    split = I4.tc_split(m, n, packed.shape[1])
    assert split > 1
    got, _, _ = _int4_tc_raw(x, packed, scales, split)
    one, _, _ = _int4_tc_raw(x, packed, scales, 1)
    again, _, _ = _int4_tc_raw(x, packed, scales, split)
    assert torch.equal(got, again)
    ref = I4.int4_matmul_plain(x, packed, scales, out_dtype=torch.float32)
    tol = _int4_tol(x, packed, scales, ref, torch.float32)
    assert bool(((one.double() - got.double()).abs() <= tol).all())


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int4_tc_quantize_is_bit_exact(cuda_device, xdt):
    """tok_scale and x_q of the tensor-core route's quantize launch equal the
    port's quant.math (which is JAX's) bit for bit, zero past K."""
    g = _gen(21)
    packed, scales = _int4_operands(5632, 256, 128, cuda_device, g)
    x = (torch.randn(40, 5632, device=cuda_device, generator=g)
         * torch.exp(torch.randn(40, 1, device=cuda_device, generator=g))).to(xdt)
    _, xq, ts = _int4_tc_raw(x, packed, scales, 1)
    q, scale = Q.quantize_act_per_token(torch.nn.functional.pad(x.float(), (0, 6144 - 5632)))
    assert torch.equal(xq, q) and torch.equal(ts, scale[:, 0])


def _int4_identity(kp, device):
    """A packed int4 weight with N = K' columns, column n holding +1 at row
    n and 0 elsewhere, scales 1 (group 128): out[m, n] = x_q[m, n] * tok_scale[m]
    with a single rounding, so the output shows x_q and tok_scale exactly."""
    k2 = kp // 2
    n = torch.arange(kp, device=device)[:, None]
    b = torch.arange(k2, device=device)[None, :]
    lo = torch.where(b == n, 9, 8)
    hi = torch.where(b + k2 == n, 9, 8)
    packed = (lo | (hi << 4)).to(torch.uint8)
    return packed, torch.ones(kp, kp // 128, device=device)


@pytest.mark.parametrize("m", [1, 2, 4, 5, 8, 33])
@pytest.mark.parametrize("k", [2048, 5632])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int4_quantize_is_bit_exact_on_every_route(cuda_device, m, k, xdt):
    """The GEMV's fused quantize (a product with the reciprocal, the true
    division near rounding ties) and the quantize launch of the other
    routes give quant.math's x_q and tok_scale bit for bit: through an
    identity weight the f32 output is x_q * tok_scale, rounded once. One row
    is built of near ties (x / tok_scale within an ulp or two of k + 0.5)."""
    g = _gen(m + k)
    kp = -(-k // 256) * 256
    x = torch.randn(m, k, device=cuda_device, generator=g) * 3
    ts0 = torch.tensor(100.0 / 127.0, device=cuda_device)
    ties = (torch.randint(-126, 126, (k,), device=cuda_device, generator=g) + 0.5) * ts0
    x[0] = torch.nextafter(ties, ties + torch.randint(-1, 2, (k,), device=cuda_device,
                                                       generator=g) * 1e3)
    x[0, 0] = 100.0
    x = x.to(xdt)
    packed, scales = _int4_identity(kp, cuda_device)
    before = I4.int4_matmul.tc_launches
    got = I4.int4_matmul(x, packed, scales, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert I4.int4_matmul.tc_launches == before + int(m > 8)
    q, ts = Q.quantize_act_per_token(torch.nn.functional.pad(x.float(), (0, kp - k)))
    assert torch.equal(got, q.float() * ts)


def test_int4_matmul_prefill_route_launches_no_kernel(cuda_device):
    """M > 64 is W4A16 in plain torch (bf16 product, f32 accumulation), as
    the JAX package computes it outside its Pallas kernel."""
    g = _gen(11)
    packed, scales = _int4_operands(2048, 512, 128, cuda_device, g)
    x = torch.randn(65, 2048, device=cuda_device, generator=g).to(torch.bfloat16)
    before = I4.int4_matmul.launches
    got = I4.int4_matmul(x, packed, scales)
    assert I4.int4_matmul.launches == before
    w = Q.dequantize_int4_grouped(packed.t(), scales.t(), torch.float32)
    ref = x.float() @ w
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2 * float(ref.abs().max()))


def test_int4_matmul_raises_on_wrong_dtype_or_device(cuda_device):
    g = _gen(12)
    packed, scales = _int4_operands(256, 64, 128, cuda_device, g)
    x = torch.zeros(2, 256, device=cuda_device)
    with pytest.raises(TypeError):
        I4.int4_matmul(x.to(torch.float16), packed, scales)
    with pytest.raises(ValueError):
        I4.int4_matmul(x, packed.cpu(), scales.cpu())
    with pytest.raises(ValueError):
        I4.int4_matmul(x, packed, scales, out_dtype=torch.int8)


def test_quant_math_on_the_card_gives_the_cpus_bytes(cuda_device):
    """Constants divide truly on the card too (PyTorch's CUDA division by a
    Python scalar multiplies by the rounded reciprocal), so every quantizer
    gives the CPU's bytes, and those are JAX's (tests/test_torch_quant_math)."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(64, 2048, generator=g) * torch.exp(
        torch.empty(64, 2048).uniform_(-6, 4, generator=g))
    for fn in (Q.quantize_act_per_token, Q.quantize_act_per_tensor_dynamic,
               Q.quantize_fp8_per_tensor, Q.quantize_fp8_per_token,
               Q.quantize_weight_per_tensor_absmax):
        for a, b in zip(fn(x), fn(x.to(cuda_device))):
            b = b.cpu()
            if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), fn.__name__
    for a, b in zip(Q.quantize_weight_int4_grouped(x.t().contiguous()),
                    Q.quantize_weight_int4_grouped(x.t().contiguous().to(cuda_device))):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("t", [1, 128, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_add_layernorm_quant_kernel_matches_plain(cuda_device, t, dtype):
    """K6 at OPT-6.7B's D = 4096, on chip_smoke.py's inputs: a common offset
    of +20 and outlier channels at +-50 sigma."""
    import chip_smoke

    h, x, gamma, beta = chip_smoke.layernorm_case(torch, t, 4096, dtype, _gen(t))
    before = F.fused_add_layernorm_quant.launches
    s, q = F.fused_add_layernorm_quant(h, x, gamma, beta, eps=1e-5)
    s_ref, q_ref = F.fused_add_layernorm_quant_plain(h, x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    assert F.fused_add_layernorm_quant.launches == before + 1
    assert torch.equal(s, s_ref)
    dq = (q.int() - q_ref.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("d", [2048, 4096, 5120, 7168, 9216, 2056])
@pytest.mark.parametrize("t", [1, 128, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_add_layernorm_quant_vector_route(cuda_device, d, t, dtype):
    """K6 with the row in registers at OPT's widths (2048 to 9216) and a
    ragged 2056 (one chunk of 8 past a multiple of 256): s equal, q within
    one step on <= 0.1% of elements."""
    import chip_smoke

    h, x, gamma, beta = chip_smoke.layernorm_case(torch, t, d, dtype, _gen(t + d))
    assert F.layernorm_route(d, h, x, gamma, beta) == "vector"
    s, q = F.fused_add_layernorm_quant(h, x, gamma, beta, eps=1e-5)
    s_ref, q_ref = F.fused_add_layernorm_quant_plain(h, x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(s, s_ref)
    dq = (q.int() - q_ref.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("d", [80, 96, 76, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("banded", [False, True])
def test_flash_attention_padded_head_dims(cuda_device, d, dtype, banded):
    """K3 at D = 80 and 96 (read as they lie, tiles zero past D up to the
    compute width 128), 40 (width 64) and 76 (padded to 80 in the wrapper),
    the caller's sm_scale kept, against plain, causal and banded, at the
    usual tolerances; the output keeps D."""
    g = _gen(d + banded)
    s = 200 if banded else 100
    q = torch.randn(3, 100, 8, d, device=cuda_device, generator=g).to(dtype)
    k = torch.randn(3, s, 4, d, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(3, s, 4, d, device=cuda_device, generator=g).to(dtype)
    atol, rtol = (1.6e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)
    if banded:
        pos = torch.tensor([0, 40, 90], dtype=torch.int32, device=cuda_device)
        starts = torch.tensor([5, 0, 60], dtype=torch.int32, device=cuda_device)
        got = A.flash_attention_banded(q, k, v, pos, starts, sm_scale=d ** -0.5)
        ref = A.flash_attention_banded_plain(q, k, v, pos, starts, sm_scale=d ** -0.5)
        rows = (pos[:, None] + torch.arange(100, device=cuda_device)[None]) >= starts[:, None]
    else:
        got = A.flash_attention(q, k, v, sm_scale=d ** -0.5)
        ref = A.flash_attention_plain(q, k, v, sm_scale=d ** -0.5)
        rows = torch.ones(3, 100, dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got[rows].float(), ref[rows].float(), rtol=rtol, atol=atol)


def test_sample_divides_by_the_true_quotient(cuda_device, monkeypatch):
    """Sampled decode scales the logits by IEEE division on the card too,
    the CPU's (and JAX's) quotient bit for bit."""
    from autosmoothquant_tpu_torch.serve import sampling as S

    logits = torch.randn(4, 32000, generator=torch.Generator().manual_seed(5)) * 7
    seen = {}

    def capture(scaled, generator):
        seen["scaled"] = scaled
        return torch.zeros(scaled.shape[0], dtype=torch.int64, device=scaled.device)
    monkeypatch.setattr(S, "_gumbel_argmax", capture)
    S.sample(logits.to(cuda_device), torch.Generator(device=cuda_device), temperature=0.7)
    assert torch.equal(seen["scaled"].cpu(), logits / 0.7)


# (max, mean) of |card - CPU| over a 2-layer OPT's logits (std ~2): W8A8 as
# the Llama test above; fp8 and int4 chip_smoke.py's limits for the 2-layer
# TinyLlama-width models (fp8 e4m3 dynamic, int4)
OPT_CARD_LIMITS = {"int8": (0.2, 1e-2), "fp8_e4m3": (0.8, 0.06), "int4": (0.01, 3e-4)}


@pytest.mark.parametrize("qtype", list(OPT_CARD_LIMITS))
def test_opt_forward_on_the_card_matches_the_cpu(cuda_device, qtype):
    """A 2-layer pre-LN OPT (chip_smoke.py's random weights, nonzero biases)
    on the card against the CPU with the same weights, f32 compute and KV
    cache: ragged prefill (banded flash; K6 in W8A8) and one decode step."""
    import chip_smoke
    from autosmoothquant_tpu_torch.models import opt as O
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    cfg = O.OPTConfig(vocab_size=1024, hidden_size=256, word_embed_proj_dim=256,
                      ffn_dim=512, num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=256)
    qcfg = QuantConfig(type=qtype)
    params = (chip_smoke.draw_opt_w8a8(cfg, seed=1, device="cpu") if qtype == "int8"
              else chip_smoke.draw_quantized(cfg, qcfg, seed=1, device="cpu",
                                             draw_float=chip_smoke.draw_opt_float))
    b, t, s_max = 3, 24, 64
    ids = torch.randint(0, cfg.vocab_size, (b, t), generator=torch.Generator().manual_seed(2))
    pads = torch.tensor([0, 5, 13], dtype=torch.int32)
    positions = torch.clamp(torch.arange(t)[None, :] - pads[:, None], min=0)
    col = torch.arange(s_max)[None, :]
    kv_valid = (col >= pads[:, None]) & (col <= t)
    valid_rows = torch.arange(t)[None, :] >= pads[:, None]
    out, tok = {}, None
    k6 = F.fused_add_layernorm_quant.launches
    for dev in ("cpu", cuda_device):
        p = chip_smoke.to_device(params, dev)
        cache = O.init_kv_cache(cfg, b, s_max, torch.float32, dev)
        with torch.inference_mode():
            h, _ = O.forward(p, ids.to(dev), cfg, qcfg, kv_cache=cache, cache_index=0,
                             pad_starts=pads.to(dev), positions=positions.to(dev))
            pre = O.logits(p, h).cpu()
            if tok is None:
                tok = pre[:, -1].argmax(-1)
            h, _ = O.forward(p, tok[:, None].to(dev), cfg, qcfg, kv_cache=cache,
                             cache_index=t, kv_valid=kv_valid.to(dev),
                             positions=(t - pads)[:, None].to(dev))
            out[str(dev)] = (pre[valid_rows], O.logits(p, h)[:, 0].cpu())
    assert F.fused_add_layernorm_quant.launches - k6 == (4 if qtype == "int8" else 0)
    max_lim, mean_lim = OPT_CARD_LIMITS[qtype]
    for cpu, card in zip(out["cpu"], out[str(cuda_device)]):
        diff = (card - cpu).abs()
        assert bool(torch.isfinite(card).all())
        assert float(diff.max()) <= max_lim and float(diff.mean()) <= mean_lim, (
            float(diff.max()), float(diff.mean()))
