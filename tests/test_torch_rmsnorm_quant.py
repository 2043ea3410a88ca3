"""``kernels/fused.py:rmsnorm_quant`` (the first RMSNorm + int8 quantize of a
Llama layer, and the final norm without the quantize) on the CPU: its plain
version against the JAX package's ``rms_norm`` followed by
``quantize_act_prescaled`` and against the port's two-op route it replaces;
and ``chip_smoke.rmsnorm_quant_ordered``, the kernel's arithmetic in torch
ops, the oracle the card holds the kernel to.

The plain version is the two ops (torch's mean), bit-equal to the old route
everywhere. Against JAX (XLA's sum order) it is bit-equal where every
partial sum is exact (integer-valued rows), round-half-even ties included;
on random rows a last-bit difference in the mean can move a value across a
rounding boundary, so the int8 stays within one step on at most 0.1% of
elements there, and the unquantized row within 2**-22 of the row's largest
value. The kernel sums the squares in an order set by D alone (the order
``rmsnorm_quant_ordered`` repeats): the same tolerances hold it to the plain
version, and a row's bits do not depend on the row count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models.common import rms_norm as jax_rms_norm
from autosmoothquant_tpu.quant.math import quantize_act_prescaled as jax_quantize
from autosmoothquant_tpu_torch.kernels.fused import rmsnorm_quant, rmsnorm_quant_plain
from autosmoothquant_tpu_torch.models.common import rms_norm
from autosmoothquant_tpu_torch.quant.math import quantize_act_prescaled
from chip_smoke import rmsnorm_quant_ordered, row_sum_squares


def _jax_chain(x, g, eps):
    return np.asarray(jax_quantize(jax_rms_norm(jnp.asarray(x), jnp.asarray(g), eps)))


def _old_route(x, g, eps):
    return quantize_act_prescaled(rms_norm(torch.from_numpy(x), torch.from_numpy(g), eps)).numpy()


def _run(fn, x, g, eps, quantize=True):
    """fn's int8 (``quantize``), or its row in x's dtype."""
    out_dtype = torch.int8 if quantize else torch.from_numpy(x).dtype
    return fn(torch.from_numpy(x), torch.from_numpy(g), eps=eps, out_dtype=out_dtype).numpy()


def _within_one_step(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("d", [64, 256, 2048, 8192])
def test_int8_bit_equal_where_the_sums_are_exact(d):
    """Integer rows in [-8, 8]: every sum of squares is an exact integer, in
    any order; gamma spreads y across the int8 range and past its clamp."""
    rng = np.random.default_rng(d)
    x = rng.integers(-8, 9, size=(24, d)).astype(np.float32)
    g = (rng.normal(size=d) * 60).astype(np.float32)
    got = _run(rmsnorm_quant_plain, x, g, 1e-6)
    np.testing.assert_array_equal(got, _jax_chain(x, g, 1e-6))
    np.testing.assert_array_equal(got, _old_route(x, g, 1e-6))
    np.testing.assert_array_equal(got, _run(rmsnorm_quant_ordered, x, g, 1e-6))
    assert got.min() == -128 and got.max() == 127  # the clamp is reached


def test_rounds_half_to_even_like_jax():
    """Rows of +-4 (mean of squares 16, eps 0: inverse root 0.25 exactly) give
    y = +-gamma exactly, so gamma lands y on ties and past the clamp."""
    x = np.full((4, 256), 4.0, np.float32)
    x[:, ::2] *= -1
    g = np.tile(np.array([0.5, 1.5, 2.5, -3.5, 126.5, 127.5, 130.0, -128.5], np.float32), 32)
    for fn in (rmsnorm_quant_plain, rmsnorm_quant_ordered):
        got = _run(fn, x, g, 0.0)
        np.testing.assert_array_equal(got[0, :8], [0, 2, -2, -4, -126, 127, -128, -128])
        np.testing.assert_array_equal(got, _jax_chain(x, g, 0.0))
        np.testing.assert_array_equal(got, _old_route(x, g, 0.0))


@pytest.mark.parametrize("d", [64, 256, 2048])
def test_random_rows_against_jax_and_the_old_route(d):
    rng = np.random.default_rng(100 + d)
    x = (rng.normal(size=(64, d)) * 3).astype(np.float32)
    g = (rng.random(d) * 40 + 5).astype(np.float32)
    got = _run(rmsnorm_quant_plain, x, g, 1e-6)
    np.testing.assert_array_equal(got, _old_route(x, g, 1e-6))
    _within_one_step(got, _jax_chain(x, g, 1e-6))
    _within_one_step(_run(rmsnorm_quant_ordered, x, g, 1e-6), got)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    for fn in (rmsnorm_quant_plain, rmsnorm_quant_ordered):
        np.testing.assert_allclose(_run(fn, x, g, 1e-6, quantize=False), ref, rtol=0,
                                   atol=2.0**-22 * np.abs(ref).max())


def test_norm_mode_writes_the_input_dtype():
    x = torch.randn(5, 256, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    g = torch.rand(256, generator=torch.Generator().manual_seed(4)) + 0.5
    out = rmsnorm_quant(x, g, eps=1e-5, out_dtype=x.dtype)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, rms_norm(x, g, 1e-5).to(torch.bfloat16))


def test_the_kernels_order_does_not_depend_on_the_row_count():
    """The contract the kernel keeps: a row's sum, and so its output, is the
    same alone and among 8 (the sum's order is set by D alone)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(8, 2048)) * 3).astype(np.float32))
    g = torch.from_numpy((rng.random(2048) * 40 + 5).astype(np.float32))
    assert torch.equal(row_sum_squares(x)[1:2], row_sum_squares(x[1:2]))
    for out_dtype in (torch.int8, x.dtype):
        batch = rmsnorm_quant_ordered(x, g, eps=1e-6, out_dtype=out_dtype)
        for r in (0, 5):
            assert torch.equal(batch[r:r + 1], rmsnorm_quant_ordered(
                x[r:r + 1], g, eps=1e-6, out_dtype=out_dtype))


def test_row_sum_squares_is_the_sum():
    rng = np.random.default_rng(8)
    for d in (64, 2048, 8192, 12288, 2056):
        x = torch.from_numpy(rng.normal(size=(3, d)).astype(np.float32))
        torch.testing.assert_close(row_sum_squares(x), (x.double() ** 2).sum(-1).float(),
                                   rtol=1e-5, atol=0)


def test_shapes_are_checked():
    with pytest.raises(ValueError):
        rmsnorm_quant(torch.zeros(2, 64), torch.ones(32))
    with pytest.raises(ValueError):
        rmsnorm_quant(torch.zeros(64), torch.ones(64))
