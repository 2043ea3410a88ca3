"""``kernels/attention.py:decode_attention`` (one query token a row over a
contiguous cache or block-paged pages) against the JAX package's ``attend``
(T = 1) and ``paged_attend`` (T = 1), on the CPU (the plain version), with
the same seeded numpy inputs; and ``models/common.py:paged_attend_plain``
(the port of JAX's online-softmax scan over blocks) against JAX's for
multi-token chunks.

Tolerances: f32 (f32 q and cache, or an int8 cache with f32 q) 1e-5, the
sums' order alone; bf16 (bf16 q and cache, output bf16, the probabilities
rounded to bf16 before the value product on both sides) atol 1.6e-2 + rtol
1e-2, one bf16 step of the outputs, as K3's bf16 route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import common as JC
from autosmoothquant_tpu_torch.kernels.attention import (decode_attention,
                                                         decode_attention_plain,
                                                         gather_pages)
from autosmoothquant_tpu_torch.models import common as TC

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1.6e-2)}


def _case(seed, b=4, s=96, hq=8, hkv=2, d=16, cache="f32", valid=False, window=0,
          block=16):
    """Numpy inputs: q [B, Hq, D], k/v [B, S, Hkv, D] (f32 values, or int8
    with per-token-per-head scales), positions [B] below S (the last row at
    S - 1), kv_valid [B, S] with left pads, and a shuffled page layout of the
    same keys: pages [N, block, Hkv, D] behind table [B, S / block] (page 0
    unused, the scratch page)."""
    rng = np.random.default_rng(seed)
    c = dict(q=rng.normal(size=(b, hq, d)).astype(np.float32), scale=1.0 / np.sqrt(d),
             window=window, ks=None, vs=None, valid=None, block=block)
    kf = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vf = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    if cache == "int8":
        ks = np.maximum(np.abs(kf).max(-1), 1e-8) / 127
        vs = np.maximum(np.abs(vf).max(-1), 1e-8) / 127
        c["k"] = np.clip(np.rint(kf / ks[..., None]), -128, 127).astype(np.int8)
        c["v"] = np.clip(np.rint(vf / vs[..., None]), -128, 127).astype(np.int8)
        c["ks"], c["vs"] = ks.astype(np.float32), vs.astype(np.float32)
    else:
        c["k"], c["v"] = kf, vf
    pos = rng.integers(0, s, size=b)
    pos[-1] = s - 1
    c["pos"] = pos.astype(np.int64)
    if valid:
        pads = rng.integers(0, 9, size=b)
        c["valid"] = np.arange(s)[None, :] >= pads[:, None]
    m = s // block
    perm = rng.permutation(b * m) + 1
    c["table"] = perm.reshape(b, m).astype(np.int32)

    def pages(x):
        out = np.zeros((b * m + 1, block) + x.shape[2:], x.dtype)
        out[perm] = x.reshape((b, m, block) + x.shape[2:]).reshape((b * m, block)
                                                                   + x.shape[2:])
        return out
    c["pages"] = {name: pages(c[name]) for name in ("k", "v", "ks", "vs")
                  if c[name] is not None}
    return c


def _mask(c):
    s = c["k"].shape[1]
    col = np.arange(s)[None, :]
    mask = col <= c["pos"][:, None]
    if c["window"]:
        mask &= col > c["pos"][:, None] - c["window"]
    if c["valid"] is not None:
        mask &= c["valid"]
    return mask


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None else t


def _port(c, dtype, paged=False, rows=None):
    b = rows or c["q"].shape[0]
    kv = (lambda x: _t(x, dtype)) if c["ks"] is None else _t
    sc = (lambda x: None if x is None else _t(x))
    if paged:
        p = c["pages"]
        return decode_attention_plain(
            _t(c["q"][:b], dtype), kv(p["k"]), kv(p["v"]), _t(c["pos"][:b]),
            scale=c["scale"], k_scale=sc(p.get("ks")), v_scale=sc(p.get("vs")),
            table=_t(c["table"][:b]), window=c["window"])
    return decode_attention_plain(
        _t(c["q"][:b], dtype), kv(c["k"][:b]), kv(c["v"][:b]), _t(c["pos"][:b]),
        scale=c["scale"], k_scale=sc(None if c["ks"] is None else c["ks"][:b]),
        v_scale=sc(None if c["vs"] is None else c["vs"][:b]),
        kv_valid=None if c["valid"] is None else _t(c["valid"][:b]), window=c["window"])


def _jax_attend(c, dtype):
    kv = (lambda x: jnp.asarray(x, dtype)) if c["ks"] is None else jnp.asarray
    out = JC.attend(jnp.asarray(c["q"][:, None], dtype), kv(c["k"]), kv(c["v"]),
                    jnp.asarray(_mask(c))[:, None, None, :], c["scale"],
                    k_scale=None if c["ks"] is None else jnp.asarray(c["ks"]),
                    v_scale=None if c["vs"] is None else jnp.asarray(c["vs"]))
    return np.asarray(out[:, 0].astype(jnp.float32))


def _jax_paged(c):
    p = c["pages"]
    kv = jnp.asarray
    out = JC.paged_attend(
        jnp.asarray(c["q"][:, None]), kv(p["k"]), kv(p["v"]), jnp.asarray(c["table"]),
        jnp.asarray(c["pos"][:, None].astype(np.int32)), c["scale"], jnp.float32,
        ks_pages=None if "ks" not in p else kv(p["ks"]),
        vs_pages=None if "vs" not in p else kv(p["vs"]), sliding_window=c["window"])
    return np.asarray(out[:, 0])


ARMS = {  # arm: (cache, q and f32-cache dtype, tolerance)
    "f32": ("f32", (jnp.float32, torch.float32), "f32"),
    "bf16": ("f32", (jnp.bfloat16, torch.bfloat16), "bf16"),
    "int8": ("int8", (jnp.float32, torch.float32), "f32"),
}


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("window,valid", [(0, False), (24, False), (0, True)],
                         ids=["causal", "window", "kv_valid"])
def test_plain_matches_jax_attend(arm, window, valid):
    cache, (jdt, tdt), tol = ARMS[arm]
    c = _case(1, cache=cache, window=window, valid=valid)
    got = _port(c, tdt).float().numpy()
    np.testing.assert_allclose(got, _jax_attend(c, jdt), **TOL[tol])


@pytest.mark.parametrize("arm", ["f32", "int8"])
@pytest.mark.parametrize("window", [0, 24])
def test_plain_over_shuffled_pages_matches_jax_paged_attend(arm, window):
    cache, (_, tdt), tol = ARMS[arm]
    c = _case(2, cache=cache, window=window)
    got = _port(c, tdt, paged=True).numpy()
    np.testing.assert_allclose(got, _jax_paged(c), **TOL[tol])
    # the same keys laid out contiguously give the same result
    np.testing.assert_allclose(got, _port(c, tdt).numpy(), **TOL[tol])


def test_bf16_pages_match_contiguous_bf16():
    c = _case(3)
    got = _port(c, torch.bfloat16, paged=True)
    want = _port(c, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)


def test_kv_window_bounds_the_scan():
    """kv_window above every row's position changes nothing."""
    c = _case(4, s=64)
    q, k, v = _t(c["q"]), _t(c["k"]), _t(c["v"])
    pos = _t(np.minimum(c["pos"], 39))
    full = decode_attention_plain(q, k, v, pos, scale=c["scale"])
    cut = decode_attention_plain(q, k, v, pos, scale=c["scale"], kv_window=40)
    torch.testing.assert_close(cut, full, rtol=0, atol=1e-6)


def test_a_row_does_not_depend_on_the_batch():
    """The contract the kernel keeps (its sums run in key order), shown on
    the plain version: row b of a batch of 8 equals the same row alone."""
    c = _case(5, b=8, hq=32, hkv=4, d=64, s=256, block=32)
    batch = _port(c, torch.float32)
    for r in (0, 3, 7):
        alone = decode_attention_plain(
            _t(c["q"][r:r + 1]), _t(c["k"][r:r + 1]), _t(c["v"][r:r + 1]),
            _t(c["pos"][r:r + 1]), scale=c["scale"])
        torch.testing.assert_close(alone[0], batch[r], rtol=0, atol=0)


def test_the_wrapper_checks_its_inputs():
    c = _case(6)
    q, k, v = _t(c["q"]), _t(c["k"]), _t(c["v"])
    with pytest.raises(ValueError):
        decode_attention(q, k[:, :, :, :8], v, 3, scale=1.0)
    with pytest.raises(ValueError):  # an int8 cache without its scales
        decode_attention(q, k.to(torch.int8), v.to(torch.int8), 3, scale=1.0)


@pytest.mark.parametrize("chunk_start,t", [(0, 16), (40, 24)])
@pytest.mark.parametrize("arm", ["f32", "int8"])
def test_paged_attend_plain_matches_jax_on_chunks(chunk_start, t, arm):
    """A prefill chunk of t tokens at positions [start, start + t) over
    shuffled pages (the port's scan against JAX's)."""
    cache = ARMS[arm][0]
    c = _case(7, b=2, s=96, cache=cache)
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, t, 8, 16)).astype(np.float32)
    pos = (chunk_start + np.arange(t))[None, :].repeat(2, 0).astype(np.int32)
    p = c["pages"]
    want = np.asarray(JC.paged_attend(
        jnp.asarray(q), jnp.asarray(p["k"]), jnp.asarray(p["v"]), jnp.asarray(c["table"]),
        jnp.asarray(pos), c["scale"], jnp.float32,
        ks_pages=None if "ks" not in p else jnp.asarray(p["ks"]),
        vs_pages=None if "vs" not in p else jnp.asarray(p["vs"])))
    got = TC.paged_attend_plain(
        _t(q), _t(p["k"]), _t(p["v"]), _t(c["table"]), _t(pos), c["scale"], torch.float32,
        ks_pages=None if "ks" not in p else _t(p["ks"]),
        vs_pages=None if "vs" not in p else _t(p["vs"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gather_pages_reads_through_the_table():
    c = _case(9)
    rows = gather_pages(_t(c["pages"]["k"]), _t(c["table"]))
    torch.testing.assert_close(rows, _t(c["k"]), rtol=0, atol=0)
