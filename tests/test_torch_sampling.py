"""The port's sampling against the JAX package's: greedy and the top-k/top-p
thresholds are equal; sampled tokens (another generator) are checked by
their distribution with a chi-square test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.serve import sampling as JS
from autosmoothquant_tpu_torch.serve import sampling as TS

# chi-square critical values at p = 0.001
_CHI2_999 = {1: 10.828, 2: 13.816, 3: 16.266, 4: 18.467, 5: 20.515,
             6: 22.458, 7: 24.322}


def test_greedy_equal():
    logits = np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32)
    t = TS.sample(torch.from_numpy(logits), None, temperature=0.0)
    j = JS.sample(jnp.asarray(logits), jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_thresholds_per_row_equal():
    rng = np.random.default_rng(1)
    scaled = rng.normal(size=(5, 40)).astype(np.float32) * 3
    top_k = np.asarray([0, 1, 5, 40, 100], np.int32)
    # (p = 1 exactly is left out: whether the last few tokens survive then
    # depends on how each framework rounds the f32 cumulative sum)
    top_p = np.asarray([0.95, 0.5, 0.9, 0.3, 1.5], np.float32)
    t = TS._thresholds_per_row(torch.from_numpy(scaled), torch.from_numpy(top_k),
                               torch.from_numpy(top_p))
    j = JS._thresholds_per_row(jnp.asarray(scaled), jnp.asarray(top_k),
                               jnp.asarray(top_p))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_repetition_penalty_equal():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 20)).astype(np.float32)
    seen = rng.random((3, 20)) < 0.4
    pen = np.asarray([1.0, 1.3, 0.7], np.float32)
    t = TS.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen),
                                    torch.from_numpy(pen))
    j = JS.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen),
                                    jnp.asarray(pen))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _chi2(counts, probs):
    expected = probs * counts.sum()
    return float(((counts - expected) ** 2 / expected).sum())


@pytest.mark.parametrize("temperature,top_k,top_p,kept", [
    (1.0, 0, 1.0, 8), (0.7, 0, 1.0, 8), (1.0, 3, 1.0, 3), (1.0, 0, 0.8, None)])
def test_sampled_frequencies_follow_the_filtered_softmax(temperature, top_k,
                                                         top_p, kept):
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0])
    n = 40000
    g = torch.Generator().manual_seed(3)
    toks = TS.sample(logits.expand(n, 8), g, temperature, top_k, top_p)
    counts = torch.bincount(toks, minlength=8).double().numpy()
    # the reference distribution: JAX's own filter, then softmax
    scaled = jnp.asarray(logits.numpy())[None] / temperature
    if top_k or top_p < 1.0:
        th = JS._thresholds_per_row(scaled, jnp.asarray([top_k], jnp.int32),
                                    jnp.asarray([top_p], jnp.float32))
        scaled = jnp.where(scaled < th, -jnp.inf, scaled)
    probs = np.asarray(jax.nn.softmax(scaled, -1))[0].astype(np.float64)
    support = probs > 0
    if kept is not None:
        assert support.sum() == kept
    assert counts[~support].sum() == 0
    df = int(support.sum()) - 1
    assert _chi2(counts[support], probs[support]) < _CHI2_999[df]


def test_generator_makes_draws_reproducible():
    logits = torch.randn(16, 100, generator=torch.Generator().manual_seed(4))
    a = TS.sample(logits, torch.Generator().manual_seed(5), 1.0)
    b = TS.sample(logits, torch.Generator().manual_seed(5), 1.0)
    c = TS.sample(logits, torch.Generator().manual_seed(6), 1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_temperature_divides_truly_like_jax(monkeypatch):
    """The logits are divided by the temperature as IEEE division rounds it,
    the JAX package's quotient bit for bit (on the card, PyTorch would
    multiply by the rounded reciprocal for a Python-scalar divisor)."""
    logits = (np.random.default_rng(3).normal(size=(4, 4096)) * 7).astype(np.float32)
    seen = {}

    def capture(scaled, generator):
        seen["scaled"] = scaled
        return torch.zeros(scaled.shape[0], dtype=torch.int64)
    monkeypatch.setattr(TS, "_gumbel_argmax", capture)
    TS.sample(torch.from_numpy(logits), torch.Generator().manual_seed(0), temperature=0.7)
    want = np.asarray(jnp.asarray(logits) / 0.7)
    np.testing.assert_array_equal(seen["scaled"].numpy(), want)


# sample_per_row: per-row parameters, one step for a mixed batch

ROW_TEMPS = np.asarray([0.0, 0.8, 0.0, 1.0, 0.5], np.float32)
ROW_TOPK = np.asarray([0, 5, 3, 0, 40], np.int64)
ROW_TOPP = np.asarray([1.0, 0.9, 0.5, 0.7, 1.5], np.float32)


def test_sample_per_row_greedy_rows_are_the_argmax_and_thresholds_equal_jax(monkeypatch):
    """Rows at temperature 0 take the argmax, bit for bit; the sampled rows'
    filtered logits (per-row temperature, then the per-row top-k / top-p
    threshold) are JAX's ``sample_per_row`` operands bit for bit."""
    logits = (np.random.default_rng(5).normal(size=(5, 300)) * 3).astype(np.float32)
    seen = {}

    def capture(masked, generator):
        seen["masked"] = masked
        return torch.zeros(masked.shape[0], dtype=torch.int64)
    monkeypatch.setattr(TS, "_gumbel_argmax", capture)
    tok = TS.sample_per_row(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                            torch.from_numpy(ROW_TEMPS), torch.from_numpy(ROW_TOPK),
                            torch.from_numpy(ROW_TOPP))
    greedy = ROW_TEMPS == 0
    np.testing.assert_array_equal(tok.numpy()[greedy], logits.argmax(-1)[greedy])
    assert (tok.numpy()[~greedy] == 0).all()
    lg = jnp.asarray(logits)
    scaled = lg / jnp.where(jnp.asarray(ROW_TEMPS) > 0, jnp.asarray(ROW_TEMPS), 1.0)[:, None]
    th = JS._thresholds_per_row(scaled, jnp.asarray(ROW_TOPK, jnp.int32),
                                jnp.asarray(ROW_TOPP))
    want = np.asarray(jnp.where(scaled < th, -jnp.inf, scaled))
    np.testing.assert_array_equal(seen["masked"].numpy(), want)
    # and JAX's own sample_per_row picks the same greedy rows
    j = JS.sample_per_row(lg, jax.random.PRNGKey(0), jnp.asarray(ROW_TEMPS),
                          jnp.asarray(ROW_TOPK, jnp.int32), jnp.asarray(ROW_TOPP))
    np.testing.assert_array_equal(np.asarray(j)[greedy], logits.argmax(-1)[greedy])


def test_sample_per_row_frequencies_follow_each_rows_filtered_softmax():
    """Two parameter sets in one batch (20,000 rows each): each row's draws
    follow the softmax its own filter leaves (chi-square at p = 0.001)."""
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0])
    n = 20000
    params = [(1.0, 0, 0.8), (0.7, 3, 1.0)]
    temps = torch.tensor([p[0] for p in params]).repeat_interleave(n)
    topk = torch.tensor([p[1] for p in params]).repeat_interleave(n)
    topp = torch.tensor([p[2] for p in params]).repeat_interleave(n)
    toks = TS.sample_per_row(logits.expand(2 * n, 8), torch.Generator().manual_seed(6),
                             temps, topk, topp)
    for i, (temperature, top_k, top_p) in enumerate(params):
        counts = torch.bincount(toks[i * n:(i + 1) * n], minlength=8).double().numpy()
        scaled = jnp.asarray(logits.numpy())[None] / temperature
        th = JS._thresholds_per_row(scaled, jnp.asarray([top_k], jnp.int32),
                                    jnp.asarray([top_p], jnp.float32))
        probs = np.asarray(jax.nn.softmax(jnp.where(scaled < th, -jnp.inf, scaled), -1)
                           )[0].astype(np.float64)
        support = probs > 0
        assert counts[~support].sum() == 0
        assert _chi2(counts[support], probs[support]) < _CHI2_999[int(support.sum()) - 1]
