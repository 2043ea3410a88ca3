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

import functools
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


def _rmsnorm_inputs(t, d, dtype, seed, device):
    g = _gen(seed)
    h = (torch.randn(t, d, device=device, generator=g) * 2).to(dtype)
    x = torch.randn(t, d, device=device, generator=g).to(dtype)
    gamma = 32 * (1 + 0.1 * torch.randn(d, device=device, generator=g))
    return h, x, gamma


@pytest.mark.parametrize("t,d", [(1, 2048), (3, 2048), (128, 2048), (512, 2048),
                                 (1, 4096), (1, 8192), (2, 12288)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_add_rmsnorm_quant_vector_route(cuda_device, t, d, dtype):
    """K2 with the row in registers at TinyLlama's, Llama-2-7B's and
    Llama-2-70B's widths and the route's limit: one launch on the vector
    route, s equal, q within one step on <= 0.1% of elements."""
    h, x, gamma = _rmsnorm_inputs(t, d, dtype, t + d, cuda_device)
    before, vec_before = F.fused_add_rmsnorm_quant.launches, F.fused_add_rmsnorm_quant.vec_launches
    s, q = F.fused_add_rmsnorm_quant(h, x, gamma, eps=1e-5)
    s_ref, q_ref = F.fused_add_rmsnorm_quant_plain(h, x, gamma, eps=1e-5)
    torch.cuda.synchronize()
    assert F.fused_add_rmsnorm_quant.launches == before + 1
    assert F.fused_add_rmsnorm_quant.vec_launches == vec_before + 1
    assert torch.equal(s, s_ref)
    dq = (q.int() - q_ref.int()).abs()
    assert int(dq.max()) <= 1 and float((dq > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("case", ["d2052", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_add_rmsnorm_quant_rows_route(cuda_device, case, dtype):
    """K2's rows route where the vector route cannot go: D = 2052 (no
    multiple of 8) and h one element past a 16-byte boundary."""
    d = 2052 if case == "d2052" else 2048
    h, x, gamma = _rmsnorm_inputs(64, d, dtype, 7, cuda_device)
    if case == "misaligned":
        buf = torch.empty(h.numel() + 1, dtype=dtype, device=cuda_device)
        h = buf[1:].view(h.shape).copy_(h)
    assert F.norm_route(d, h, x, gamma) == "rows"
    before, vec_before = F.fused_add_rmsnorm_quant.launches, F.fused_add_rmsnorm_quant.vec_launches
    s, q = F.fused_add_rmsnorm_quant(h, x, gamma, eps=1e-5)
    s_ref, q_ref = F.fused_add_rmsnorm_quant_plain(h, x, gamma, eps=1e-5)
    torch.cuda.synchronize()
    assert F.fused_add_rmsnorm_quant.launches == before + 1
    assert F.fused_add_rmsnorm_quant.vec_launches == vec_before
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
    assert F.norm_route(d, h, x, gamma, beta) == "vector"
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


def _graph_model(label):
    """(family module, config, QuantConfig, params on the card): 2 layers at
    TinyLlama-1.1B's width (W8A8, fp8 e4m3 dynamic, int4) or OPT-1.3B's
    (W8A8), chip_smoke.py's random weights."""
    import chip_smoke
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.models import opt as O
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    if label == "OPT W8A8":
        cfg = O.OPTConfig(**chip_smoke.OPT_1_3B_2L)
        return O, cfg, QuantConfig(type="int8"), chip_smoke.draw_opt_w8a8(cfg, 5, "cuda")
    cfg = chip_smoke.tinyllama(L, 2)
    qcfg = QuantConfig(type={"W8A8": "int8", "fp8": "fp8_e4m3", "int4": "int4"}[label])
    params = (chip_smoke.draw_w8a8(cfg, 5, "cuda") if label == "W8A8"
              else chip_smoke.draw_quantized(cfg, qcfg, 5, "cuda"))
    return L, cfg, qcfg, params


def _graph_and_eager(label):
    from autosmoothquant_tpu_torch.serve.engine import Engine

    M, cfg, qcfg, params = _graph_model(label)
    return {g: Engine(M, params, cfg, qcfg, max_batch=4, max_seq=256,
                      kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                      device="cuda", cuda_graph=g) for g in (True, False)}


@pytest.mark.parametrize("label", ["W8A8", "fp8", "int4", "OPT W8A8"])
def test_graph_decode_equals_eager(cuda_device, label):
    """Decode replayed from a CUDA graph against the eager loop on the same
    params, over two calls of different b (a ragged 4-row batch, then an
    equal 2-row one, each its own graph): equal greedy tokens and bit-equal
    last logits. On the host the graph's call launches its prefill, the
    warm-up step and the capture, the eager call its prefill and every step;
    a profile of replays of the graph shows, for every port kernel, the
    device launches of one step as those host counts give it."""
    import chip_smoke
    from autosmoothquant_tpu_torch.kernels.counters import launch_counters, read_counts
    from autosmoothquant_tpu_torch.serve.engine import GenerationConfig, device_config

    engs = _graph_and_eager(label)
    counters = launch_counters()
    rng = torch.Generator().manual_seed(3)
    batches = ([torch.randint(0, 32000, (n,), generator=rng).tolist() for n in (40, 33, 20, 9)],
               [torch.randint(0, 32000, (24,), generator=rng).tolist() for _ in range(2)])
    n = 12
    for prompts in batches:
        got = {}
        for graph, eng in engs.items():
            before = read_counts(counters)
            toks = eng.generate(prompts, GenerationConfig(max_new_tokens=n))
            after = read_counts(counters)
            got[graph] = (toks, eng.last_logits,
                          {k: after[k] - before[k] for k in after if after[k] != before[k]})
        (toks, logits, host), (toks_x, logits_x, host_x) = got[True], got[False]
        assert toks == toks_x
        assert torch.equal(logits, logits_x)
        # prefill + 2 decode forwards from the host, against prefill + n - 1
        assert host.keys() == host_x.keys()
        step = {k: (host_x[k] - host[k]) // (n - 3) for k in host}
        assert all(host_x[k] - host[k] == (n - 3) * step[k] for k in host)
        captured = engs[True].graphs[(len(prompts), device_config(GenerationConfig()))]
        assert chip_smoke.replay_counts(torch, captured.graph) == chip_smoke.as_device_reads(
            {**dict.fromkeys(chip_smoke.DEVICE_READS, 0), **step})
        if label == "W8A8":
            k2, k2_vec = "fused_add_rmsnorm_quant", "fused_add_rmsnorm_quant_vec"
            assert step[k2_vec] == step[k2] == 2
            assert host[k2_vec] == host[k2] == 2 * 3
    assert engs[True].replays == 2 * (n - 2) and len(engs[True].graphs) == 2
    assert engs[False].replays == 0 and not engs[False].graphs


def test_graph_replays_a_captured_key_without_capturing_again(cuda_device):
    """A second call with the same b and device config (eos, stop and
    max_new_tokens differ) replays every decode step of the graph it has."""
    from autosmoothquant_tpu_torch.serve.engine import GenerationConfig

    eng = _graph_and_eager("W8A8")[True]
    prompts = [[5, 6, 7, 8], [9, 10, 11, 12]]
    first = eng.generate(prompts, GenerationConfig(max_new_tokens=10))
    again = eng.generate(prompts, GenerationConfig(max_new_tokens=14, eos_token_id=-1,
                                                   stop=((-5,),)))
    assert len(eng.graphs) == 1 and eng.replays == 8 + 13
    assert again[0][:10] == first[0] and again[1][:10] == first[1]


def test_sampled_graph_decode_equals_eager_for_a_seed(cuda_device):
    """temperature 0.8, top_p 0.9, seed 7: the graph (the engine's generator
    registered with it) gives the eager loop's tokens; the same seed again
    gives them again, another seed others."""
    from autosmoothquant_tpu_torch.serve.engine import GenerationConfig

    engs = _graph_and_eager("W8A8")
    prompts = [[5, 9, 1, 77, 3, 8, 100], [7, 7, 2], [300, 1, 2, 3]]
    gc = GenerationConfig(max_new_tokens=16, temperature=0.8, top_p=0.9)
    got = {g: eng.generate(prompts, gc, seed=7) for g, eng in engs.items()}
    assert got[True] == got[False]
    assert engs[True].generate(prompts, gc, seed=7) == got[True]
    assert engs[True].generate(prompts, gc, seed=8) != got[True]
    assert engs[True].replays == 14 + 15 + 15


def _continuous(graph, max_batch=4, seed=7):
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine

    M, cfg, qcfg, params = _graph_model("W8A8")
    return ContinuousEngine(M, params, cfg, qcfg, max_batch=max_batch, max_seq=256,
                            steps_per_sync=4, prefill_chunk=32, kv_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16, seed=seed, device="cuda",
                            cuda_graph=graph)


def _continuous_requests(n_plain):
    """A registered prefix and requests: two that start with it, n_plain
    plain ones (chunked), a sampled one."""
    rng = torch.Generator().manual_seed(9)

    def toks(n):
        return torch.randint(0, 32000, (n,), generator=rng).tolist()
    prefix = toks(40)
    reqs = [(f"p{i}", prefix + toks(7 + 20 * i), dict(max_new_tokens=12, prefix="sys"))
            for i in range(2)]
    reqs += [(f"r{i}", toks(5 + 7 * i), dict(max_new_tokens=6 + 2 * i))
             for i in range(n_plain)]
    reqs.append(("s", toks(21), dict(max_new_tokens=14, temperature=0.8, top_p=0.9)))
    return prefix, reqs


def _serve(eng, prefix, reqs):
    eng.register_prefix("sys", prefix)
    for uid, p, kw in reqs:
        eng.submit(uid, p, **kw)
    return eng.run()


@pytest.mark.parametrize("max_batch", [4, 16], ids=["b4-gemv", "b16-tensor-cores"])
def test_continuous_graph_decode_equals_eager(cuda_device, max_batch):
    """The continuous engine at 2-layer TinyLlama width (W8A8): decode
    replayed from CUDA graphs against the eager loop on the same params and
    requests (chunked, prefixed, one sampled, more requests than slots):
    equal tokens, bit-equal last logits. A replay launches one step's port
    kernels on the device: 8 int8 GEMMs (the GEMV at max_batch 4, the tensor
    cores at 16, where the step's M is 16), 2 K2, 2 decode attention and 3
    rmsnorm_quant (each layer's first norm, and the final norm)."""
    import chip_smoke

    prefix, reqs = _continuous_requests(max_batch + 3)
    got = {g: (_serve(e, prefix, reqs), e.last_logits, e)
           for g, e in ((g, _continuous(g, max_batch)) for g in (True, False))}
    assert got[True][0] == got[False][0]
    assert torch.equal(got[True][1], got[False][1])
    eng = got[True][2]
    assert eng.graphs and eng.replays > 0 and not got[False][2].graphs
    route = "int8_matmul_gemv" if max_batch <= 8 else "int8_matmul_tc"
    want = {**dict.fromkeys(chip_smoke.DEVICE_READS, 0), "int8_matmul": 8, route: 8,
            "fused_add_rmsnorm_quant": 2, "fused_add_rmsnorm_quant_vec": 2,
            "rmsnorm_quant": 3, "rmsnorm_quant_norm": 1, "decode_attention": 2}
    chip_smoke.park(eng)
    for captured in eng.graphs.values():
        assert chip_smoke.replay_counts(torch, captured.graph) == want


def test_continuous_step_writes_below_the_pool_edge(cuda_device, monkeypatch):
    """Every cache index the decode step writes is < the pool's slot count
    (max_seq + 1): a parked row (free, or mid-prefill) writes at the scratch
    slot max_seq, never past it (a CUDA index out of bounds is a device
    assert). Read from the eager step's per-row writes; the graph engine
    then serves the same requests with rows parked throughout."""
    from autosmoothquant_tpu_torch.models import common as C

    seen = []
    write = C._write

    def spy(buf, val, cache_index):
        if C._is_vector_index(cache_index):
            slots = C.cache_slots(cache_index, val.shape[0], val.shape[1])
            seen.append((int(slots.max()), int(slots.min()), buf.shape[1]))
        return write(buf, val, cache_index)
    monkeypatch.setattr(C, "_write", spy)
    prefix, reqs = _continuous_requests(1)
    eager = _continuous(False)
    out = _serve(eager, prefix, reqs)
    assert seen and all(0 <= lo and hi < size for hi, lo, size in seen)
    assert max(hi for hi, _, _ in seen) == eager.max_seq  # the scratch slot was written
    monkeypatch.setattr(C, "_write", write)
    graph = _continuous(True)
    assert _serve(graph, prefix, reqs) == out
    torch.cuda.synchronize()


def test_serve_on_the_card_answers_generate_as_the_engine(cuda_device):
    """The HTTP facade over a graph ContinuousEngine on the card (2-layer
    TinyLlama width, W8A8): after one warm-up request (its capture runs on
    the scheduler thread), each /generate reply, one request at a time,
    equals the same engine driven directly with that one request once the
    scheduler has stopped: the same graph at the same batch shape, so the
    same bits."""
    from autosmoothquant_tpu_torch.serve.api import serve

    from test_torch_util import http_post, start_server, stop_server

    eng = _continuous(True)
    _, reqs = _continuous_requests(3)
    api, httpd, port = start_server(serve, eng)
    try:
        assert http_post(port, "/generate", {"prompt": [1, 2, 3], "max_new_tokens": 4})[0] == 200
        replies = {}
        for uid, p, kw in reqs[2:5]:
            status, out = http_post(port, "/generate", {"prompt": p, **kw})
            assert status == 200
            replies[uid] = out["tokens"]
    finally:
        stop_server(api, httpd)
    assert api.fatal is None and eng.graphs
    for uid, p, kw in reqs[2:5]:
        eng.submit(uid, p, **kw)
        assert eng.run()[uid] == replies[uid]


# ---------------------------------------------------------------------------
# the port's own kernels: rmsnorm_quant and decode_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 128])
def test_rmsnorm_quant_kernel_bit_equal_to_its_ordered_arithmetic(cuda_device, t):
    """Bit-equal to chip_smoke.rmsnorm_quant_ordered (the kernel's sum order
    in torch ops) in both modes, a row's bits the same alone, and the int8
    within one step of the plain version on <= 0.1% of elements."""
    from chip_smoke import rmsnorm_quant_ordered

    g = _gen(t)
    for d in (2048, 4096):
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(t, d, device="cuda", generator=g) * 2).to(dt)
            gamma = 32 * (1 + 0.1 * torch.randn(d, device="cuda", generator=g))
            for quantize in (True, False):
                out = F.rmsnorm_quant(x, gamma, eps=1e-5, quantize=quantize)
                assert torch.equal(out, rmsnorm_quant_ordered(x, gamma, eps=1e-5,
                                                              quantize=quantize))
                assert torch.equal(out[:1], F.rmsnorm_quant(x[:1], gamma, eps=1e-5,
                                                            quantize=quantize))
            q = F.rmsnorm_quant(x, gamma, eps=1e-5)
            diff = (q.int() - F.rmsnorm_quant_plain(x, gamma, eps=1e-5).int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_decode_attention_kernel_matches_plain(cuda_device, paged, cache):
    """TinyLlama's heads at b8 over 256 columns (the last row parked at
    256): within bf16 tolerance of the plain version (atol 1.6e-2 + rtol
    1e-2), row 0 bit-equal alone, contiguous and paged (shuffled pages of
    32 behind a table with a scratch column)."""
    from autosmoothquant_tpu_torch.models.common import _quantize_kv

    g = _gen(50 + paged)
    b, s, hq, hkv, d, bs = 8, 257, 32, 4, 64, 32
    q = torch.randn(b, hq, d, device="cuda", generator=g).to(torch.bfloat16)
    kf, vf = (torch.randn(b, s, hkv, d, device="cuda", generator=g) for _ in range(2))
    pos = torch.randint(0, 256, (b,), device="cuda", generator=g)
    pos[-1] = 256
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    table = None
    if paged:
        m = -(-s // bs)
        perm = torch.randperm(b * m, device="cuda", generator=g) + 1
        table = torch.zeros((b, m + 1), dtype=torch.int32, device="cuda")
        table[:, :m] = perm.reshape(b, m).int()

        def pages(x):
            out = torch.zeros((b * m + 1, bs, *x.shape[2:]), dtype=x.dtype, device="cuda")
            pad = torch.zeros((b, m * bs - s, *x.shape[2:]), dtype=x.dtype, device="cuda")
            out[perm] = torch.cat([x, pad], 1).reshape(b * m, bs, *x.shape[2:])
            return out
        k, v = pages(k), pages(v)
        ks, vs = (None, None) if ks is None else (pages(ks), pages(vs))

    def run(fn, rows):
        cut = (lambda x: x) if paged else (lambda x: None if x is None else x[:rows])
        return fn(q[:rows], cut(k), cut(v), pos[:rows], scale=d ** -0.5, k_scale=cut(ks),
                  v_scale=cut(vs), table=None if table is None else table[:rows],
                  kv_window=256)
    out, ref = run(A.decode_attention, b), run(A.decode_attention_plain, b)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1.6e-2)
    assert torch.equal(run(A.decode_attention, 1)[0], out[0])


def _paged_copy(x, b, m, bs, perm):
    """Rows [B, m * bs, ...] cut into pages of bs behind table columns
    perm.reshape(b, m) (page 0 the scratch page)."""
    out = torch.zeros((b * m + 1, bs, *x.shape[2:]), dtype=x.dtype, device="cuda")
    out[perm] = x.reshape(b * m, bs, *x.shape[2:])
    return out


@pytest.mark.parametrize("heads,s,paged,cache", [
    ((32, 8, 128), 16384, False, "bf16"),   # Llama-3-8B / Mistral-7B: G = 4, D 128
    ((32, 4, 64), 8192, True, "int8"),       # TinyLlama: G = 8, D 64
], ids=["G4-D128-S16K-contiguous-bf16", "G8-D64-S8K-paged-int8"])
def test_decode_attention_past_shared_memory(cuda_device, heads, s, paged, cache):
    """Long contexts (past what one block kept in shared memory before the
    cluster design), the score rows kept in shared memory (the route these
    shapes take) against recomputed in the later passes (forced): the same
    bits, within the plain version's long-context tolerance (atol 1e-3 +
    rtol 1e-2: the outputs are about 0.01-0.02 here, and bf16's atol of
    1.6e-2 would pass a kernel that dropped a round of keys), and a row's
    bits the same alone and over its first 1024 columns."""
    from autosmoothquant_tpu_torch.models.common import _quantize_kv

    hq, hkv, d = heads
    b, bs = 2, 64
    kv_dtype = torch.int8 if cache == "int8" else torch.bfloat16
    assert A.decode_keeps_scores(hq // hkv, d, s, kv_dtype)
    g = _gen(s + paged)
    q = torch.randn(b, hq, d, device="cuda", generator=g).to(torch.bfloat16)
    kf, vf = (torch.randn(b, s, hkv, d, device="cuda", generator=g) for _ in range(2))
    pos = torch.tensor([1000, s - 1], device="cuda")
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    table = None
    if paged:
        m = s // bs
        perm = torch.randperm(b * m, device="cuda", generator=g) + 1
        table = torch.zeros((b, m + 1), dtype=torch.int32, device="cuda")
        table[:, :m] = perm.reshape(b, m).int()
        k, v, ks, vs = (None if x is None else _paged_copy(x, b, m, bs, perm)
                        for x in (k, v, ks, vs))

    def run(fn, rows, kv_window):
        cut = (lambda x: x) if paged else (lambda x: None if x is None else x[:rows])
        return fn(q[:rows], cut(k), cut(v), pos[:rows], scale=d ** -0.5, k_scale=cut(ks),
                  v_scale=cut(vs), table=None if table is None else table[:rows],
                  kv_window=kv_window)
    out, ref = run(A.decode_attention, b, s), run(A.decode_attention_plain, b, s)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-3)
    assert torch.equal(run(A.decode_attention, 1, s)[0], out[0])
    assert torch.equal(run(A.decode_attention, 1, 1024)[0], out[0])
    recompute = functools.partial(A.decode_attention, recompute_scores=True)
    assert torch.equal(run(recompute, b, s), out)


def _edge_case(pos0, seed, window=0, valid=None):
    """TinyLlama's heads (Hq 32, Hkv 4, D 64) at b8 over 1024 columns, bf16:
    row 0 at ``pos0`` (with kv_valid ``valid`` [1025] where given), the
    other rows at random positions."""
    b, s, hq, hkv, d = 8, 1025, 32, 4, 64
    g = _gen(seed)
    q = torch.randn(b, hq, d, device="cuda", generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.randint(0, s - 1, (b,), device="cuda", generator=g)
    pos[0] = pos0
    kv_valid = None
    if valid is not None:
        kv_valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        kv_valid[0] = valid
    return dict(q=q, k=k, v=v, pos=pos, kv_valid=kv_valid, window=window, scale=d ** -0.5)


def _edge_run(fn, c, rows):
    return fn(c["q"][:rows], c["k"][:rows], c["v"][:rows], c["pos"][:rows],
              scale=c["scale"], kv_valid=None if c["kv_valid"] is None else c["kv_valid"][:rows],
              window=c["window"], kv_window=1024)


# csrc/decode_attn.cu's kNC (CTAs of a cluster) and kC (keys a chunk)
_NC, _C = 8, 32
_EDGES = {"0": 0, "C-1": _C - 1, "C": _C, "NC*C-1": _NC * _C - 1, "NC*C": _NC * _C,
          "NC*C+1": _NC * _C + 1}


def _edge_check(c):
    out, ref = _edge_run(A.decode_attention, c, 8), _edge_run(A.decode_attention_plain, c, 8)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1.6e-2)
    assert torch.equal(_edge_run(A.decode_attention, c, 1)[0], out[0])
    return out


@pytest.mark.parametrize("at", list(_EDGES))
def test_decode_attention_at_the_chunk_and_cluster_edges(cuda_device, at):
    """Row 0 at the positions where one CTA of the cluster is active (0,
    C - 1), where the second takes a chunk (C), where all NC are (NC C - 1),
    and where CTA 0 takes its second chunk (NC C, NC C + 1): within bf16
    tolerance of the plain version, row 0 bit-equal alone and in the batch."""
    _edge_check(_edge_case(_EDGES[at], 60 + len(at)))


def test_decode_attention_window_starting_inside_a_chunk(cuda_device):
    """A sliding window of 40 at position 300: it starts at 261, inside the
    chunk [256, 288)."""
    _edge_check(_edge_case(300, 70, window=40))


def test_decode_attention_kv_valid_emptying_whole_chunks(cuda_device):
    """kv_valid pads over the first 2 C columns (two whole chunks, each a
    CTA's) of a row at position 200."""
    valid = torch.arange(1025, device="cuda") >= 2 * _C
    _edge_check(_edge_case(200, 71, valid=valid))


def test_decode_attention_row_with_no_valid_key_is_zero(cuda_device):
    valid = torch.zeros(1025, dtype=torch.bool, device="cuda")
    c = _edge_case(500, 72, valid=valid)
    out = _edge_run(A.decode_attention, c, 8)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(_edge_run(A.decode_attention, c, 1)[0], out[0])
    ref = _edge_run(A.decode_attention_plain, c, 8)
    torch.testing.assert_close(out[1:].float(), ref[1:].float(), rtol=1e-2, atol=1.6e-2)


@pytest.mark.parametrize("heads,cache,paged", [
    ((64, 1, 128), "f32", False),   # G = 64, D 128, f32: the most shared memory
    ((32, 2, 80), "bf16", True),    # G = 16, D 80 (pieces not a multiple of 64)
    ((48, 4, 96), "int8", False),   # G = 12, D 96
    ((16, 16, 64), "bf16", False),  # G = 1, D 64
], ids=["G64-D128-f32", "G16-D80-paged-bf16", "G12-D96-int8", "G1-D64-bf16"])
def test_decode_attention_other_head_shapes(cuda_device, heads, cache, paged):
    """Head shapes the engines' models do not give the kernel (several score
    head groups, several heads a warp, several (head, column) pairs a
    thread, D not a multiple of 64) at b4 over 512 columns: within the
    plain version's tolerance (f32 1e-5; bf16 atol 1.6e-2 + rtol 1e-2), row
    0 bit-equal alone, and the scores recomputed bit-equal to kept."""
    from autosmoothquant_tpu_torch.models.common import _quantize_kv

    hq, hkv, d = heads
    b, s, bs = 4, 513, 32
    g = _gen(hq + d)
    qd = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(b, hq, d, device="cuda", generator=g).to(qd)
    kf, vf = (torch.randn(b, s, hkv, d, device="cuda", generator=g) for _ in range(2))
    pos = torch.randint(0, 512, (b,), device="cuda", generator=g)
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(qd), vf.to(qd), None, None
    table = None
    if paged:
        m = -(-s // bs)
        perm = torch.randperm(b * m, device="cuda", generator=g) + 1
        table = torch.zeros((b, m + 1), dtype=torch.int32, device="cuda")
        table[:, :m] = perm.reshape(b, m).int()
        pad = lambda x: torch.cat([x, x.new_zeros((b, m * bs - s, *x.shape[2:]))], 1)  # noqa: E731
        k, v = (_paged_copy(pad(x), b, m, bs, perm) for x in (k, v))

    def run(fn, rows):
        cut = (lambda x: x) if paged else (lambda x: None if x is None else x[:rows])
        return fn(q[:rows], cut(k), cut(v), pos[:rows], scale=d ** -0.5, k_scale=cut(ks),
                  v_scale=cut(vs), table=None if table is None else table[:rows],
                  kv_window=512)
    out, ref = run(A.decode_attention, b), run(A.decode_attention_plain, b)
    tol = dict(rtol=1e-5, atol=1e-5) if qd == torch.float32 else dict(rtol=1e-2, atol=1.6e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(run(A.decode_attention, 1)[0], out[0])
    assert torch.equal(run(functools.partial(A.decode_attention, recompute_scores=True), b),
                       out)


def test_paged_engine_sliding_window_on_the_card(cuda_device):
    """A sliding-window Llama (window 24, D 64) on the PagedEngine on the
    card, graph decode, f32 and int8 pages: a registered prefix and prompts
    prefilled in chunks of 16 (the window binds in the chunks, through the
    masked eager route over the gathered pages, and in decode) give the
    ContinuousEngine's tokens on the card."""
    from autosmoothquant_tpu_torch.bench import draw_float
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=256, sliding_window=24)
    params = draw_float(cfg, 11, "cuda", proj_dtype=torch.float32)
    rng = torch.Generator().manual_seed(12)
    prefix = torch.randint(1, 512, (40,), generator=rng).tolist()
    reqs = [(f"p{i}", prefix + torch.randint(1, 512, (9 + 13 * i,), generator=rng).tolist(),
             dict(max_new_tokens=20, prefix="sys")) for i in range(2)]
    reqs += [(f"r{i}", torch.randint(1, 512, (5 + 17 * i,), generator=rng).tolist(),
              dict(max_new_tokens=20)) for i in range(3)]
    for kv in (torch.float32, torch.int8):
        kw = dict(max_batch=4, max_seq=128, prefill_chunk=16, steps_per_sync=4,
                  kv_dtype=kv, compute_dtype=torch.float32, device="cuda")
        engines = (PagedEngine(L, params, cfg, block_size=16, auto_prefix=False,
                               cuda_graph=True, **kw),
                   ContinuousEngine(L, params, cfg, cuda_graph=False, **kw))
        outs = []
        for eng in engines:
            eng.register_prefix("sys", prefix)
            for uid, p, r_kw in reqs:
                eng.submit(uid, p, **r_kw)
            outs.append(eng.run())
        assert outs[0] == outs[1], kv
        # the prefix holds its 2 full blocks and its tail
        assert engines[0].free_pages == engines[0].num_pages - engines[0].scratch_pages - 3


def test_continuous_engine_decodes_past_shared_memory(cuda_device):
    """A 6,100-token prompt at 2-layer TinyLlama width (W8A8, max_seq 8192):
    its decode steps scan more than 6,144 columns, past what the score rows
    can keep in shared memory at G = 8 (about 5.9K), so decode attention
    takes its workspace inside the captured graphs. Graph tokens equal
    eager tokens, and the last logits are bit-equal and finite."""
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine

    M, cfg, qcfg, params = _graph_model("W8A8")
    prompt = torch.randint(0, 32000, (6100,), generator=torch.Generator().manual_seed(3))
    got = []
    for graph in (True, False):
        eng = ContinuousEngine(M, params, cfg, qcfg, max_batch=2, max_seq=8192,
                               steps_per_sync=4, prefill_chunk=2048,
                               kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                               device="cuda", cuda_graph=graph)
        eng.submit("long", prompt.tolist(), max_new_tokens=12)
        got.append((eng.run()["long"], eng.last_logits))
    assert got[0][0] == got[1][0] and len(got[0][0]) == 12
    assert torch.equal(got[0][1], got[1][1]) and bool(torch.isfinite(got[0][1]).all())


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_verify_rows_equal_single_rows(cuda_device, paged, cache):
    """A speculative verify's attention: decode attention over B x (gamma +
    1) queries as rows (``models/common.py:DecodeRows``: the contiguous
    cache seen as one page a row, or the paged table's rows repeated)
    equals each query alone, a T = 1 call at its position, bit for bit
    (TinyLlama's heads, gamma 4, rows at 0, 37, 129 and the cache's end)."""
    from autosmoothquant_tpu_torch.models.common import (
        _quantize_kv, attend_rows, cache_slots, decode_rows)

    g = _gen(70 + paged)
    b, t, s, hq, hkv, d, bs = 4, 5, 256, 32, 4, 64, 32
    q = torch.randn(b, t, hq, d, device="cuda", generator=g).to(torch.bfloat16)
    kf, vf = (torch.randn(b, s, hkv, d, device="cuda", generator=g) for _ in range(2))
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    slots = cache_slots(torch.tensor([0, 37, 129, s - t], device="cuda"), b, t)
    table = None
    if paged:
        m = s // bs
        perm = torch.randperm(b * m, device="cuda", generator=g) + 1
        table = torch.zeros((b, m + 1), dtype=torch.int32, device="cuda")
        table[:, :m] = perm.reshape(b, m).int()
        k, v = _paged_copy(k, b, m, bs, perm), _paged_copy(v, b, m, bs, perm)
        if ks is not None:
            ks, vs = _paged_copy(ks, b, m, bs, perm), _paged_copy(vs, b, m, bs, perm)
    got = attend_rows(q, k, v, decode_rows(table, slots, None), d ** -0.5, ks, vs)
    for i in range(b):
        def row(x):
            return x if paged or x is None else x[i:i + 1]
        for j in range(t):
            one = A.decode_attention(q[i, j][None], row(k), row(v), slots[i, j],
                                     scale=d ** -0.5, k_scale=row(ks), v_scale=row(vs),
                                     table=None if table is None else table[i:i + 1])
            assert torch.equal(one[0], got[i, j]), (i, j)


def _spec_engines(graph, kind, draft=False):
    """A speculative engine (gamma 4) of ``kind`` ("static", "continuous" or
    "paged") on the 2-layer W8A8 model, with a 1-layer W8A8 draft where
    asked."""
    import chip_smoke
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.engine import DraftModel, Engine
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    M, cfg, qcfg, params = _graph_model("W8A8")
    kw = dict(max_batch=4, max_seq=256, kv_dtype=torch.bfloat16,
              compute_dtype=torch.bfloat16, device="cuda", cuda_graph=graph)
    if draft:
        dcfg = chip_smoke.tinyllama(L, 1)
        kw["draft"] = DraftModel(L, chip_smoke.draw_w8a8(dcfg, 6, "cuda"), dcfg, qcfg)
    if kind == "static":
        return Engine(M, params, cfg, qcfg, **kw)
    kw.update(steps_per_sync=4, prefill_chunk=32, seed=7, speculative_gamma=4)
    if kind == "paged":
        return PagedEngine(M, params, cfg, qcfg, block_size=32, **kw)
    return ContinuousEngine(M, params, cfg, qcfg, **kw)


@pytest.mark.parametrize("draft", [False, True], ids=["ngram", "draft"])
@pytest.mark.parametrize("kind", ["static", "continuous", "paged"])
def test_speculative_graph_equals_eager(cuda_device, kind, draft):
    """Speculative decoding from CUDA graphs (a static round, the continuous
    and paged engines' verifies) against the same engines run eagerly:
    equal tokens (the sampled request's too: one schedule), equal to plain
    greedy graph decode, and the static engine's statistics equal."""
    from autosmoothquant_tpu_torch.serve.engine import GenerationConfig

    engs = {g: _spec_engines(g, kind, draft) for g in (True, False)}
    if kind == "static":
        phrase = list(range(500, 516))
        prompts = [phrase * 6, list(range(900, 960))]
        spec = GenerationConfig(max_new_tokens=40, speculative_gamma=4)
        out = {g: e.generate(prompts, spec) for g, e in engs.items()}
        assert out[True] == out[False]
        assert out[True] == engs[True].generate(prompts, GenerationConfig(max_new_tokens=40))
        assert engs[True].last_spec_stats == engs[False].last_spec_stats
        assert any(isinstance(key[1], str) for key in engs[True].graphs)
        return
    prefix, reqs = _continuous_requests(4)
    out = {g: _serve(e, prefix, reqs) for g, e in engs.items()}
    assert out[True] == out[False]
    assert any(isinstance(key[0], str) for key in engs[True].graphs)
    plain = _continuous(True)
    want = _serve(plain, prefix, reqs)
    assert all(out[True][u] == want[u] for u, _, kw in reqs if "temperature" not in kw)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_writes_stay_in_each_rows_own_slots_on_the_card(cuda_device, paged):
    """The verify graph (gamma 4, 6 rows, pages of 4 slots: a parked row's
    5 writes span 2 scratch pages) with each row in turn active at the last
    length a verify may take and the others parked: the writes are
    exactly the rows' own slots, none shared, parked rows only in their
    scratch slots; no index leaves the pool (a device assert otherwise)."""
    from autosmoothquant_tpu_torch.serve.batching import ContinuousEngine
    from autosmoothquant_tpu_torch.serve.paged import PagedEngine

    from test_torch_util import check_verify_writes

    M, cfg, qcfg, params = _graph_model("W8A8")
    kw = dict(max_batch=6, max_seq=64, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
              device="cuda", speculative_gamma=4)
    eng = (PagedEngine(M, params, cfg, qcfg, block_size=4, **kw) if paged
           else ContinuousEngine(M, params, cfg, qcfg, **kw))
    check_verify_writes(eng, 4)
    torch.cuda.synchronize()
    assert eng.graphs


def _alibi(hq, device):
    from autosmoothquant_tpu_torch.models.baichuan import alibi_slopes

    return alibi_slopes(hq).to(device)


@pytest.mark.parametrize("heads,b,t,s", [
    ((8, 1, 256), 1, 128, 128),      # Gemma-2B: G = 8, D 256
    ((16, 16, 256), 2, 200, 200),    # Gemma-7B: G = 1, D 256
    ((40, 40, 128), 1, 128, 128),    # Baichuan-2-13B: G = 1, D 128
], ids=["gemma2b", "gemma7b", "baichuan13b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_flash_attention_head_dim_256_and_alibi(cuda_device, heads, b, t, s, dtype, banded,
                                                alibi):
    """K3 at width 256 (Gemma: Q read from shared memory, 32-key tiles on
    the bf16 route; 128 KB of shared memory on the f32 route) and with ALiBi
    slopes (m_h * key column after the scale, before the mask), causal and
    banded (chunks at cache slots 0, 37, ... over rows of s + 64 columns,
    the first columns before ``starts`` masked), against the plain version
    at the usual tolerances (f32 atol 2e-5 + rtol 1e-5, bf16 atol 1.6e-2 +
    rtol 1e-2)."""
    hq, hkv, d = heads
    g = _gen(hq + d + 3 * banded + alibi)
    cols = s + 64 if banded else t
    q = torch.randn(b, t, hq, d, device=cuda_device, generator=g).to(dtype)
    k = torch.randn(b, cols, hkv, d, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(b, cols, hkv, d, device=cuda_device, generator=g).to(dtype)
    slopes = _alibi(hq, cuda_device) if alibi else None
    atol, rtol = (1.6e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)
    if banded:
        pos = torch.tensor([37 * i for i in range(b)], dtype=torch.int32, device=cuda_device)
        starts = torch.tensor([5 * i for i in range(b)], dtype=torch.int32, device=cuda_device)
        got = A.flash_attention_banded(q, k, v, pos, starts, sm_scale=d ** -0.5,
                                       alibi_slopes=slopes)
        ref = A.flash_attention_banded_plain(q, k, v, pos, starts, sm_scale=d ** -0.5,
                                             alibi_slopes=slopes)
        rows = (pos[:, None] + torch.arange(t, device=cuda_device)[None]) >= starts[:, None]
    else:
        got = A.flash_attention(q, k, v, sm_scale=d ** -0.5, alibi_slopes=slopes)
        ref = A.flash_attention_plain(q, k, v, sm_scale=d ** -0.5, alibi_slopes=slopes)
        rows = torch.ones(b, t, dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[rows].float(), ref[rows].float(), rtol=rtol, atol=atol)


def _decode_operands(heads, b, s, cache, paged, seed, bs=32):
    """q, k, v, k_scale, v_scale, table of a decode attention case: rows of
    s columns (int8: quantized per token and head), or the same rows cut
    into shuffled pages of bs behind a table (page 0 the scratch page)."""
    from autosmoothquant_tpu_torch.models.common import _quantize_kv

    hq, hkv, d = heads
    g = _gen(seed)
    qd = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(b, hq, d, device="cuda", generator=g).to(qd)
    kf, vf = (torch.randn(b, s, hkv, d, device="cuda", generator=g) for _ in range(2))
    if cache == "int8":
        (k, ks), (v, vs) = _quantize_kv(kf), _quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(qd), vf.to(qd), None, None
    table = None
    if paged:
        m = -(-s // bs)
        perm = torch.randperm(b * m, device="cuda", generator=g) + 1
        table = torch.zeros((b, m + 1), dtype=torch.int32, device="cuda")
        table[:, :m] = perm.reshape(b, m).int()
        pad = lambda x: torch.cat([x, x.new_zeros((b, m * bs - s, *x.shape[2:]))], 1)  # noqa: E731
        k, v, ks, vs = (None if x is None else _paged_copy(pad(x), b, m, bs, perm)
                        for x in (k, v, ks, vs))
    return q, k, v, ks, vs, table


@pytest.mark.parametrize("heads,cache,paged,alibi", [
    ((8, 1, 256), "bf16", False, False),     # Gemma-2B
    ((8, 1, 256), "bf16", True, False),
    ((8, 1, 256), "int8", False, False),
    ((16, 16, 256), "f32", False, False),    # Gemma-7B heads, f32: 2-chunk rounds
    ((40, 40, 128), "bf16", False, True),    # Baichuan-2-13B, ALiBi
    ((40, 40, 128), "bf16", True, True),
    ((40, 40, 128), "int8", False, True),
    ((40, 40, 128), "f32", True, True),
    ((8, 1, 256), "bf16", True, True),       # D 256 and ALiBi together
], ids=["gemma2b-bf16", "gemma2b-paged", "gemma2b-int8", "gemma7b-f32", "baichuan-bf16",
        "baichuan-paged", "baichuan-int8", "baichuan-paged-f32", "d256-alibi-paged"])
def test_decode_attention_head_dim_256_and_alibi(cuda_device, heads, cache, paged, alibi):
    """Decode attention at D = 256 (a lane's pieces of 8 columns run to 8)
    and with ALiBi slopes (m_h * the key's position: the cache slot, or the
    logical position through the page table), b8 over 512 columns, rows at
    positions up to 511: within the plain version's tolerance (f32 1e-5;
    bf16 atol 1.6e-2 + rtol 1e-2; f32 with ALiBi 1e-4: the biased scores
    reach m_0 * 511 = 430, where an f32 step is 3e-5, and a score's rounding
    moves its probability by as much), each row bit-equal alone and in the
    batch, and the scores recomputed bit-equal to kept."""
    hq, hkv, d = heads
    b, s = 8, 512
    q, k, v, ks, vs, table = _decode_operands(heads, b, s, cache, paged, hq + d + alibi)
    pos = torch.randint(0, s, (b,), device="cuda", generator=_gen(5))
    pos[0] = s - 1
    slopes = _alibi(hq, "cuda") if alibi else None

    def run(fn, rows):
        cut = (lambda x: x) if paged else (lambda x: None if x is None else x[:rows])
        return fn(q[:rows], cut(k), cut(v), pos[:rows], scale=d ** -0.5, k_scale=cut(ks),
                  v_scale=cut(vs), table=None if table is None else table[:rows],
                  kv_window=s, alibi_slopes=slopes)
    before = A.decode_attention.launches
    out, ref = run(A.decode_attention, b), run(A.decode_attention_plain, b)
    assert A.decode_attention.launches == before + 1
    f32_tol = 1e-4 if alibi else 1e-5
    tol = (dict(rtol=f32_tol, atol=f32_tol) if cache == "f32"
           else dict(rtol=1e-2, atol=1.6e-2))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(run(A.decode_attention, 1)[0], out[0])
    assert torch.equal(run(functools.partial(A.decode_attention, recompute_scores=True), b),
                       out)


@pytest.mark.parametrize("heads,paged", [((40, 40, 128), False), ((8, 1, 256), True)],
                         ids=["baichuan-alibi-contiguous", "gemma2b-alibi-paged"])
def test_decode_attention_alibi_over_16k_columns(cuda_device, heads, paged):
    """ALiBi at 16K columns (the bias m_h * j reaches 1.4e4 on the first
    head, where an f32 step is 1e-3): bf16 cache, b2 with rows at 1000 and
    16383, scores kept and recomputed (the same bits), within the
    long-context tolerance (atol 1e-3 + rtol 1e-2), a row's bits the same
    alone and over its first 1024 columns."""
    hq, hkv, d = heads
    b, s = 2, 16384
    q, k, v, ks, vs, table = _decode_operands(heads, b, s, "bf16", paged, s + hq, bs=64)
    pos = torch.tensor([1000, s - 1], device="cuda")
    slopes = _alibi(hq, "cuda")

    def run(fn, rows, kv_window):
        cut = (lambda x: x) if paged else (lambda x: x[:rows])
        return fn(q[:rows], cut(k), cut(v), pos[:rows], scale=d ** -0.5,
                  table=None if table is None else table[:rows], kv_window=kv_window,
                  alibi_slopes=slopes)
    out, ref = run(A.decode_attention, b, s), run(A.decode_attention_plain, b, s)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-3)
    assert torch.equal(run(A.decode_attention, 1, s)[0], out[0])
    assert torch.equal(run(A.decode_attention, 1, 1024)[0], out[0])
    recompute = functools.partial(A.decode_attention, recompute_scores=True)
    assert torch.equal(run(recompute, b, s), out)


# --- the MoE router (kernels/moe.py) and the Mixtral model on the card


@pytest.mark.parametrize("rows,d,e,wdt", [(1, 4096, 8, torch.float32), (128, 4096, 8, torch.float32),
                                          (37, 1024, 8, torch.bfloat16), (5, 64, 4, torch.float32),
                                          (9, 4096, 12, torch.float32)])
def test_router_logits_kernel_matches_plain_and_is_batch_invariant(cuda_device, rows, d, e, wdt):
    """The router's f32 GEMV against its plain version (relative 1e-5 of
    sum |x||w|: f32 sums in another order), and each row's bits the same
    alone as in the batch (the cuBLAS product differs there)."""
    from autosmoothquant_tpu_torch.kernels import moe

    g = _gen(rows + d + e)
    x = torch.randn(rows, d, device=cuda_device, generator=g) * 30
    w = (torch.randn(d, e, device=cuda_device, generator=g) / math.sqrt(d)).to(wdt)
    before = moe.router_logits.launches
    got = moe.router_logits(x, w)
    torch.cuda.synchronize()
    assert moe.router_logits.launches == before + 1
    ref = moe.router_logits_plain(x, w)
    scale = (x.abs() @ w.float().abs()).double()
    assert bool(((got.double() - ref.double()).abs() <= 1e-5 * scale + 1e-30).all())
    for r in {0, rows // 2, rows - 1}:
        assert torch.equal(moe.router_logits(x[r:r + 1], w)[0], got[r])


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3", "int4"])
def test_mixtral_card_matches_cpu_on_both_routes(cuda_device, quant):
    """A tiny Mixtral (hidden 256, 8 experts of 512, top 2) quantized on the
    CPU: card against CPU logits of a T 48 prefill (the sparse route) and a
    b3 decode step (the dense route), max 0.2 and mean 1e-2 (a W8A8 model's
    card-vs-CPU bar); each route's K1 / K4 / K5 launches one a expert
    projection."""
    from autosmoothquant_tpu_torch.kernels.counters import launch_counters, read_counts
    from autosmoothquant_tpu_torch.models import mixtral as MX
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    cfg = MX.MixtralConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                           num_local_experts=8, max_position_embeddings=128)
    qcfg = QuantConfig(**({"type": "int4", "group_size": 64} if quant == "int4"
                          else {"type": quant}))
    params = MX.init_params(cfg, seed=1, device="cpu")
    ids = torch.randint(0, 512, (3, 16), generator=torch.Generator().manual_seed(2))
    stats = MX.forward(params, ids, cfg, capture_stats=True, calibrate_all_experts=True)[2]
    qp = MX.quantize(MX.smooth(params, stats, cfg=cfg) if quant == "int8" else params, qcfg,
                     MX.layer_scales(stats), cfg=cfg)
    kernel = {"int8": "int8_matmul", "fp8_e4m3": "fp8_matmul", "int4": "int4_matmul"}[quant]
    counters = launch_counters()
    out, tok = {}, None
    for dev in ("cpu", "cuda"):
        p = _to(qp, dev)
        cache = MX.init_kv_cache(cfg, 3, 32, torch.float32, dev)
        with torch.inference_mode():
            before = read_counts(counters)
            h, _ = MX.forward(p, ids.to(dev), cfg, qcfg, kv_cache=cache, cache_index=0)
            pre = read_counts(counters)
            if tok is None:  # the CPU's greedy token feeds both decode steps
                tok = MX.logits(p, h)[:, -1].argmax(-1)
            h2, _ = MX.forward(p, tok[:, None].to(dev), cfg, qcfg, kv_cache=cache,
                               cache_index=16)
            after = read_counts(counters)
        out[dev] = (MX.logits(p, h).cpu(), MX.logits(p, h2).cpu())
        if dev == "cuda":
            # 4 attention projections and 3 a expert, every layer, both routes
            assert pre[kernel] - before[kernel] == 2 * (4 + 3 * 8)
            assert after[kernel] - pre[kernel] == 2 * (4 + 3 * 8)
            assert after["router_logits"] - before["router_logits"] == 4
    for a, b in zip(out["cuda"], out["cpu"]):
        diff = (a - b).abs()
        assert float(diff.max()) <= 0.2 and float(diff.mean()) <= 1e-2, quant


def _to(node, dev):
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dev) for v in node]
    return node.to(dev)


def test_device_time_times_on_cuda_events(cuda_device):
    """utils/profiling.py:device_time on a card tensor: the median of CUDA
    event pairs, within 2x of an event-timed loop of the same product (a
    host clock without a synchronize would read the enqueue alone)."""
    from autosmoothquant_tpu_torch.utils.profiling import device_time

    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16)
    t = device_time(torch.mm, a, a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        torch.mm(a, a)
    end.record()
    end.synchronize()
    loop = start.elapsed_time(end) / 20 / 1e3
    assert 0.5 * loop < t < 2 * loop, (t, loop)


def _tiny_w8a8_lm(dev, **kw):
    import chip_smoke
    from autosmoothquant_tpu_torch.eval.lm_adapter import TorchLM
    from autosmoothquant_tpu_torch.models import llama as L
    from autosmoothquant_tpu_torch.quant.config import QuantConfig

    cfg = L.LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = chip_smoke.to_device(chip_smoke.draw_w8a8(cfg, seed=1, device="cpu"), dev)
    return TorchLM(L, params, cfg, QuantConfig(type="int8"), device=dev, **kw)


def test_torch_lm_loglikelihoods_card_match_cpu(cuda_device):
    """A 2-layer W8A8 TorchLM (f32 compute) scores the same requests on the
    card (K1, K2, K3's f32 route, rmsnorm_quant) and on the CPU: each
    log-likelihood within 0.05 a continuation token (a logit's card-vs-CPU
    bar is 0.2, its mean 1e-2), and the card's launches one scored batch's."""
    from autosmoothquant_tpu_torch.kernels.counters import launch_counters, read_counts

    g = torch.Generator().manual_seed(3)
    reqs = [(torch.randint(0, 1024, (n,), generator=g).tolist(),
             torch.randint(0, 1024, (k,), generator=g).tolist())
            for n, k in ((5, 3), (40, 7), (100, 1), (12, 20))]
    counters = launch_counters()
    want = _tiny_w8a8_lm("cpu", batch_size=4, max_length=128).loglikelihood(reqs)
    before = read_counts(counters)
    got = _tiny_w8a8_lm(cuda_device, batch_size=4, max_length=128).loglikelihood(reqs)
    after = read_counts(counters)
    for (a, _), (b, _), (_, cont) in zip(got, want, reqs):
        assert abs(a - b) <= 0.05 * len(cont), (got, want)
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    # one batch of 4 (T 128): 7 GEMMs, one K2, one first norm and K3 a layer
    assert launched["int8_matmul"] == launched["int8_matmul_tc"] == 14
    assert launched["fused_add_rmsnorm_quant"] == 2 and launched["flash_attention"] == 2
    assert launched["rmsnorm_quant"] == 3 and launched["rmsnorm_quant_norm"] == 1


def test_torch_lm_keeps_one_engine_across_generate_calls(cuda_device):
    """Three generate_until calls of batch 2 build one Engine and capture one
    decode graph, which the later calls replay; the same prompts give the
    same tokens through it."""
    lm = _tiny_w8a8_lm(cuda_device, batch_size=2, max_length=128)
    prompts = [[5, 6, 7], [1, 2, 3, 4]]
    first = lm.generate_until(prompts, max_new_tokens=12)
    eng = lm.engine
    replays = eng.replays
    other = lm.generate_until([[9, 9], [8, 8, 8, 8, 8]], max_new_tokens=12)
    again = lm.generate_until(prompts, max_new_tokens=12)
    assert lm.engines_built == 1 and lm.engine is eng and len(eng.graphs) == 1
    assert eng.replays == replays + 2 * 11 and again == first
    assert all(len(t) == 12 for t in first + other)
