"""Per-row cache indices (continuous batching's decode step) in the port
against the JAX package's functions on the same numpy inputs: the vector
``cache_slots`` and ``_write`` / ``cache_write`` into plain and int8 caches
bit for bit, and a decode forward with an int32 [B] ``cache_index`` and
per-row positions, with and without ``kv_window`` and with a sliding window,
whose logits agree within ``tests/test_torch_llama.py``'s cached-arm
tolerances (float 1e-5, int8 3e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import common as JC
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.models import common as TC
from autosmoothquant_tpu_torch.models import llama as TL

from test_torch_util import jax_llama, port_config, port_qcfg, to_numpy_tree

B, S, H, D = 4, 40, 2, 16
ROWS = np.asarray([0, 7, 33, 39], np.int32)  # each row's slot; the last one at S - 1


def test_vector_cache_slots_equal_jax():
    t = TC.cache_slots(torch.from_numpy(ROWS).long(), B, 1)
    np.testing.assert_array_equal(t.numpy(), np.asarray(JC.cache_slots(jnp.asarray(ROWS), B, 1)))
    t3 = TC.cache_slots(torch.from_numpy(ROWS - 2).long(), B, 3)
    np.testing.assert_array_equal(
        t3.numpy(), np.asarray(JC.cache_slots(jnp.asarray(ROWS - 2), B, 3)))


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_vector_cache_write_equals_jax(quant, t):
    rng = np.random.default_rng(0)
    idx = np.minimum(ROWS, S - t).astype(np.int32)
    k = rng.normal(size=(B, t, H, D)).astype(np.float32)
    v = rng.normal(size=(B, t, H, D)).astype(np.float32)
    base = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if quant:
        q = rng.integers(-128, 128, size=(B, S, H, D)).astype(np.int8)
        sc = rng.random((B, S, H)).astype(np.float32)
        jcache = JC.QuantKVCacheLayer(*(jnp.asarray(x) for x in (q, q, sc, sc)))
        tcache = TC.QuantKVCacheLayer(*(torch.from_numpy(x.copy()) for x in (q, q, sc, sc)))
    else:
        jcache = JC.KVCacheLayer(jnp.asarray(base), jnp.asarray(base))
        tcache = TC.KVCacheLayer(torch.from_numpy(base.copy()), torch.from_numpy(base.copy()))
    want = JC.cache_write(jcache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx))
    TC.cache_write(tcache, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(idx).long())
    for name in want._fields:
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(want, name)))


def _caches(cfg, kv, s_max, seed):
    """The same random cache state for both packages: JAX's stacked layer
    and the port's per-layer list (int8: random values and scales)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_hidden_layers, 4, s_max, cfg.num_key_value_heads, cfg.head_dim)
    if kv == "int8":
        leaves = [rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2)]
        leaves += [(rng.random(shape[:-1]) * 0.02 + 0.005).astype(np.float32)
                   for _ in range(2)]
        j = JC.QuantKVCacheLayer(*(jnp.asarray(x) for x in leaves))
        t = [TC.QuantKVCacheLayer(*(torch.from_numpy(x[i].copy()) for x in leaves))
             for i in range(shape[0])]
    else:
        leaves = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
        j = JC.KVCacheLayer(*(jnp.asarray(x) for x in leaves))
        t = [TC.KVCacheLayer(*(torch.from_numpy(x[i].copy()) for x in leaves))
             for i in range(shape[0])]
    return j, t


# (quant config, KV, sliding window, logit tolerance)
DECODE_ARMS = {"float": (None, "f32", 0, 1e-5),
               "int8_kv": ({"type": "int8"}, "int8", 0, 3e-2),
               "float_sliding_window": (None, "f32", 24, 1e-5)}


@pytest.mark.parametrize("kv_window", [None, 256])
@pytest.mark.parametrize("arm", list(DECODE_ARMS))
def test_decode_at_per_row_slots_matches_jax(arm, kv_window):
    """One decode step of 4 rows at slots 5, 130, 60 and 201 of a 512-slot
    cache (positions = slots), the cache filled with the same random state:
    logits within the arm's tolerance; kv_window bounds the columns read and
    changes nothing (the port's logits are bit-equal to its full read)."""
    qkw, kv, window, tol = DECODE_ARMS[arm]
    JL, cfg, params, qcfg = jax_llama(qkw, seed=4, sliding_window=window)
    s_max = 512
    lens = np.asarray([5, 130, 60, 201], np.int32)
    tok = np.asarray([3, 17, 99, 512], np.int32)
    jcache, tcache = _caches(cfg, kv, s_max, seed=5)

    h, _, _ = jax.jit(lambda p, c: JL.forward(
        p, jnp.asarray(tok)[:, None], cfg, qcfg, kv_cache=c, cache_index=jnp.asarray(lens),
        positions=jnp.asarray(lens)[:, None], kv_window=kv_window,
        compute_dtype=jnp.float32))(params, jcache)
    want = np.asarray(JL.logits(params, h))[:, 0]

    tparams = params_from_jax(to_numpy_tree(params), device="cpu")
    tcfg, tq = port_config(cfg), port_qcfg(qcfg)

    def port_logits(window_cols):
        cache = [type(layer)(*(x.clone() for x in TC.dataclasses.astuple(layer)))
                 for layer in tcache]
        idx = torch.from_numpy(lens).long()
        with torch.inference_mode():
            th, _ = TL.forward(tparams, torch.from_numpy(tok).long()[:, None], tcfg, tq,
                               kv_cache=cache, cache_index=idx, positions=idx[:, None],
                               kv_window=window_cols, compute_dtype=torch.float32)
            return TL.logits(tparams, th)[:, 0].numpy()
    got = port_logits(kv_window)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if kv_window is not None:
        np.testing.assert_array_equal(got, port_logits(None))
