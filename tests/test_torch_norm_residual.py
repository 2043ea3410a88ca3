"""``kernels/fused.py:rmsnorm_quant``'s residual mode (the add before the norm
folded into its launch) and the forwards that fold every layer-boundary add
into the next norm, on the CPU.

The kernel's plain version against the JAX package's ops it stands for: the
residual add in the stream's dtype (``autosmoothquant_tpu/models/llama.py:234``,
``h + attn_out``), ``rms_norm`` and ``quantize_act_prescaled``, in each
output form (int8, f32, bf16), at T 1 / 8 / 128 and D 64 / 2048, f32 and
bf16 streams, inputs drawn with numpy. ``tests/test_torch_rmsnorm_quant.py``'s
tolerances: s (the new stream) bit-equal to JAX's rounded sum everywhere;
the int8 output bit-equal where every partial sum is exact (integer rows);
elsewhere, where a last-bit difference in the mean or the inverse root
(XLA's sum order and ``lax.rsqrt`` against torch's mean and 1 / sqrt) can
move a value across a rounding boundary, int8 within one step on at most
0.1% of elements, f32 within 2**-22 of the row block's largest value, and
bf16 (that f32 value rounded once) within one bf16 step (2**-7 of the
value) on at most 0.1%.
``chip_smoke.rmsnorm_quant_ordered`` (the kernel's arithmetic, which the
card is held to bit for bit) takes the residual too: s bit-equal, the
output within the same limits of the plain version, and a row's bits the
same alone and in a batch.

Then the Llama, Gemma, Baichuan and Mixtral forwards (W8A8 per tensor and
per token, fp8 e4m3, int4, bf16 and f32 weights; a prefill and a decode
step on a cache) and the 2-stage pipeline (two gloo ranks) against the same
forwards with the old ops patched in (a torch add at the layer's end, then
``rms_norm`` or the launch without the residual, and the final norm of the
completed sum): the logits and hidden states bit-equal, so the fold moves
nothing on the CPU. A norm before int4 (W4A8) projections stays the torch
ops on every device (``models/common.py:norm_dtype`` None).
"""

import numpy as np
import pytest
import torch

from autosmoothquant_tpu_torch.kernels.fused import rms_norm, rmsnorm_quant, rmsnorm_quant_plain
from autosmoothquant_tpu_torch.quant.math import quantize_act_prescaled
from chip_smoke import draw_baichuan, draw_float, draw_mixtral, draw_quantized, draw_w8a8
from chip_smoke import rmsnorm_quant_ordered
from test_torch_util import one_torch_thread  # noqa: F401  (module fixture)

T_D = [(t, d) for t in (1, 8, 128) for d in (64, 2048)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FORMS = {"int8": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}
EPS = 1e-6


def _draw(t, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # sums in [-8, 8], squares and their sums exact in any order
        x, r = (rng.integers(-4, 5, size=(t, d)).astype(np.float32) for _ in range(2))
        g = (rng.normal(size=d) * 30).astype(np.float32)
    else:
        x = (rng.normal(size=(t, d)) * 2).astype(np.float32)
        r = rng.normal(size=(t, d)).astype(np.float32)
        g = (rng.random(d) * 40 + 5).astype(np.float32)
    return x, r, g


def _jax_chain(x, r, g, dtype):
    """JAX's ops: (the sum in ``dtype`` as f32 numpy, the f32 norm, its int8)."""
    import jax.numpy as jnp
    from autosmoothquant_tpu.models.common import rms_norm as jax_rms_norm
    from autosmoothquant_tpu.quant.math import quantize_act_prescaled as jax_quantize

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    s = jnp.asarray(x, jdt) + jnp.asarray(r, jdt)
    y = jax_rms_norm(s, jnp.asarray(g), EPS)
    return tuple(np.array(v) for v in (s.astype(jnp.float32), y, jax_quantize(y)))


def _torch(x, r, g, dtype):
    return torch.from_numpy(x).to(dtype), torch.from_numpy(r).to(dtype), torch.from_numpy(g)


def _within(form, got, y_ref, q_ref):
    """Hold one output form to JAX's f32 norm y_ref (its int8 q_ref)."""
    if form == "int8":
        diff = np.abs(got.numpy().astype(np.int32) - q_ref.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    elif form == "f32":
        np.testing.assert_allclose(got.numpy(), y_ref, rtol=0,
                                   atol=2.0**-22 * np.abs(y_ref).max())
    else:
        ref = torch.from_numpy(y_ref).to(torch.bfloat16).float().numpy()
        diff = np.abs(got.float().numpy() - ref)
        assert (diff <= 2.0**-7 * np.abs(ref)).all() and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,d", T_D)
def test_the_new_stream_is_jaxs_rounded_sum(t, d, dt):
    x, r, g = _draw(t, d, 10 * t + d)
    xt, rt, gt = _torch(x, r, g, DTYPES[dt])
    s, _ = rmsnorm_quant(xt, gt, eps=EPS, residual=rt)
    assert s.dtype == DTYPES[dt]
    np.testing.assert_array_equal(s.float().numpy(), _jax_chain(x, r, g, DTYPES[dt])[0])
    assert torch.equal(s, xt + rt)  # the torch add it replaces


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,d", T_D)
def test_residual_mode_against_jax_and_the_old_ops(t, d, dt, form):
    """Each output form against JAX's add, rms_norm (and quantize) within
    the stated limits, and bit-equal to the port's old ops: a torch add,
    then rms_norm, then the prescaled quantize or the cast."""
    x, r, g = _draw(t, d, 10 * t + d + 1)
    xt, rt, gt = _torch(x, r, g, DTYPES[dt])
    s, out = rmsnorm_quant(xt, gt, eps=EPS, out_dtype=FORMS[form], residual=rt)
    assert out.dtype == FORMS[form] and out.shape == (t, d)
    _, y_ref, q_ref = _jax_chain(x, r, g, DTYPES[dt])
    _within(form, out, y_ref, q_ref)
    y_old = rms_norm(xt + rt, gt, EPS)
    old = quantize_act_prescaled(y_old) if form == "int8" else y_old.to(FORMS[form])
    assert torch.equal(out, old)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("d", [64, 256, 2048])
def test_residual_mode_bit_equal_to_jax_where_the_sums_are_exact(d, dt):
    x, r, g = _draw(24, d, d, integer=True)
    xt, rt, gt = _torch(x, r, g, DTYPES[dt])
    s_ref, y_ref, q_ref = _jax_chain(x, r, g, DTYPES[dt])
    for form, odt in FORMS.items():
        s, out = rmsnorm_quant(xt, gt, eps=EPS, out_dtype=odt, residual=rt)
        np.testing.assert_array_equal(s.float().numpy(), s_ref)
        if form == "int8":
            np.testing.assert_array_equal(out.numpy(), q_ref)
            assert out.min() == -128 and out.max() == 127  # the clamp is reached
        else:  # JAX's lax.rsqrt against 1 / sqrt: the last bit of y may differ
            _within(form, out, y_ref, q_ref)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("t,d", T_D)
def test_the_ordered_oracle_takes_the_residual(t, d, dt):
    """chip_smoke.rmsnorm_quant_ordered with the residual: s bit-equal to
    the plain version's, each output within the limits of it, the
    composition (the sum, then the oracle without the residual) bit-equal,
    and a row's bits the same alone as in the batch."""
    x, r, g = _draw(t, d, 10 * t + d + 2)
    xt, rt, gt = _torch(x, r, g, DTYPES[dt])
    for form, odt in FORMS.items():
        s, out = rmsnorm_quant_ordered(xt, gt, eps=EPS, out_dtype=odt, residual=rt)
        s_ref, ref = rmsnorm_quant_plain(xt, gt, eps=EPS, out_dtype=odt, residual=rt)
        assert torch.equal(s, s_ref)
        assert torch.equal(out, rmsnorm_quant_ordered(xt + rt, gt, eps=EPS, out_dtype=odt))
        y = rms_norm(s_ref, gt, EPS).numpy()
        _within(form, out, y, quantize_act_prescaled(torch.from_numpy(y)).numpy())
        s1, one = rmsnorm_quant_ordered(xt[-1:], gt, eps=EPS, out_dtype=odt, residual=rt[-1:])
        assert torch.equal(s1, s[-1:]) and torch.equal(one, out[-1:])


def test_the_output_forms_and_their_checks():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    r = torch.randn(3, 64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    g = torch.ones(64)
    assert rmsnorm_quant(x, g).dtype == torch.int8
    assert rmsnorm_quant(x, g, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    assert rmsnorm_quant(x, g, out_dtype=torch.float32).dtype == torch.float32
    s, y = rmsnorm_quant(x, g, out_dtype=torch.bfloat16, residual=r)
    assert s.dtype == y.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        rmsnorm_quant(x, g, residual=r[:2])
    with pytest.raises(ValueError):
        rmsnorm_quant(x, g, residual=r.float())
    with pytest.raises(TypeError):
        rmsnorm_quant(x, g, out_dtype=torch.float16)


def test_add_rms_norm_and_the_norms_dtype():
    from autosmoothquant_tpu_torch.models.common import add_rms_norm, norm_dtype

    h = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    p = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    g = torch.rand(64, generator=torch.Generator().manual_seed(5)) + 0.5
    s, y = add_rms_norm(h, p, g, EPS, torch.float32)
    assert s.shape == y.shape == h.shape and torch.equal(s, h + p)
    assert torch.equal(y, rms_norm(h + p, g, EPS))
    same, y0 = add_rms_norm(h, None, g, EPS, torch.int8)
    assert same is h and torch.equal(y0, quantize_act_prescaled(rms_norm(h, g, EPS)))
    bf16 = {"w": torch.zeros(64, 8, dtype=torch.bfloat16)}
    int8 = {"w": torch.zeros(8, 64, dtype=torch.int8)}
    assert norm_dtype(True, [int8]) == torch.int8
    assert norm_dtype(False, [bf16, bf16]) == torch.bfloat16
    assert norm_dtype(False, [bf16, int8]) == torch.float32
    assert norm_dtype(False, [{"w": torch.zeros(64, 8)}]) == torch.float32


def test_a_norm_before_int4_keeps_the_torch_ops():
    """Before int4 (W4A8) projections the norm is no launch: the torch add,
    then rms_norm in f32, on any device."""
    from autosmoothquant_tpu_torch.models.common import add_rms_norm, norm_dtype

    int4 = {"w": torch.zeros(8, 32, dtype=torch.uint8)}
    bf16 = {"w": torch.zeros(64, 8, dtype=torch.bfloat16)}
    assert norm_dtype(False, [int4]) is None and norm_dtype(False, [bf16, int4]) is None
    assert norm_dtype(True, [int4]) == torch.int8
    h = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    p = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    g = torch.rand(64, generator=torch.Generator().manual_seed(8)) + 0.5
    before = rmsnorm_quant.launches
    s, y = add_rms_norm(h, p, g, EPS, None)
    assert torch.equal(s, h + p) and torch.equal(y, rms_norm(h + p, g, EPS))
    same, y0 = add_rms_norm(h, None, g, EPS, None)
    assert same is h and torch.equal(y0, rms_norm(h, g, EPS)) and y0.dtype == torch.float32
    assert rmsnorm_quant.launches == before


def test_the_batch_variance_probes_name_what_the_modules_call():
    """``chip_smoke.py:locate_batch_variance`` wraps functions by name in the
    model modules (``VARIANCE_PROBES``): each must be there and called there,
    or the card's probe fails or records nothing."""
    import importlib
    import inspect
    import re

    from chip_smoke import VARIANCE_PROBES

    for mod_name, names in VARIANCE_PROBES.items():
        mod = importlib.import_module(f"autosmoothquant_tpu_torch.models.{mod_name}")
        src = inspect.getsource(mod)
        for name in names:
            assert callable(getattr(mod, name, None)), (mod_name, name)
            assert re.search(rf"(?<![\w.]){name}\(", src), (mod_name, name)


# ---------------------------------------------------------------------------
# the forwards against the old ops
# ---------------------------------------------------------------------------

LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
GEMMA = dict(LLAMA, hidden_act="gelu_tanh", head_dim_override=32)
BAICHUAN = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=4, model_max_length=64)
MIXTRAL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
               num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
               max_position_embeddings=64)
B, T = 2, 8


def _old_add_rms_norm(h, pending, weight, eps, out_dtype):
    """The ops before the fold: the previous layer's torch add, then the
    int8 launch without the residual before a prescaled projection, else
    rms_norm in f32 (whose consumer casts it itself)."""
    if pending is not None:
        h = h + pending
    if out_dtype == torch.int8:
        return h, rmsnorm_quant(h.reshape(-1, h.shape[-1]), weight, eps=eps).reshape(h.shape)
    return h, rms_norm(h, weight, eps)


def _old_head(params, h, cfg, compute_dtype, pending=None):
    """The final norm before the fold: the last layer's torch add, then the
    launch without the residual, in h's dtype."""
    if pending is not None:
        h = h + pending
    return rmsnorm_quant(h.reshape(-1, h.shape[-1]), params["final_norm"]["w"],
                         eps=cfg.rms_norm_eps, out_dtype=h.dtype).reshape(h.shape)


@pytest.fixture
def old_ops(monkeypatch):
    """Patch the old ops into the family modules (Gemma runs the Llama
    module's functions)."""
    from autosmoothquant_tpu_torch.models import baichuan, llama, mixtral

    def patch():
        for mod in (llama, baichuan, mixtral):
            monkeypatch.setattr(mod, "add_rms_norm", _old_add_rms_norm)
            monkeypatch.setattr(mod, "head", _old_head)
    return patch


def _model(family, fmt):
    """(module, config, QuantConfig or None, params on the CPU, compute
    dtype) of a small model of ``family`` in ``fmt``."""
    from autosmoothquant_tpu_torch.models import baichuan as TB
    from autosmoothquant_tpu_torch.models import llama as TL
    from autosmoothquant_tpu_torch.models import mixtral as TM
    from autosmoothquant_tpu_torch.quant.config import PER_TOKEN, QuantConfig

    int4 = QuantConfig(type="int4", group_size=32)
    fp8 = QuantConfig(type="fp8_e4m3")
    bf = torch.bfloat16
    if family in ("llama", "gemma"):
        cfg = TL.LlamaConfig(**(LLAMA if family == "llama" else GEMMA))
        return {
            "W8A8": lambda: (TL, cfg, QuantConfig(type="int8"), draw_w8a8(cfg, 1, "cpu"), bf),
            "W8A8 fused": lambda: (TL, cfg, QuantConfig(type="int8"),
                                   TL.fuse_decode_projections(draw_w8a8(cfg, 1, "cpu")), bf),
            "W8A8 f32": lambda: (TL, cfg, QuantConfig(type="int8"), draw_w8a8(cfg, 1, "cpu"),
                                 torch.float32),
            "W8A8 per-token": lambda: (TL, cfg, QuantConfig(qkv=PER_TOKEN, fc1=PER_TOKEN),
                                       draw_w8a8(cfg, 1, "cpu"), bf),
            "fp8": lambda: (TL, cfg, fp8, draw_quantized(cfg, fp8, 1, "cpu"), bf),
            "int4": lambda: (TL, cfg, int4, draw_quantized(cfg, int4, 1, "cpu"), bf),
            "bf16": lambda: (TL, cfg, None, draw_float(cfg, 1, "cpu"), bf),
            "bf16 fused": lambda: (TL, cfg, None,
                                   TL.fuse_decode_projections(draw_float(cfg, 1, "cpu")), bf),
            "f32": lambda: (TL, cfg, None, draw_float(cfg, 1, "cpu", torch.float32),
                            torch.float32),
        }[fmt]()
    if family == "baichuan":
        cfg = TB.BaichuanConfig(**BAICHUAN)
        if fmt == "int4":
            params = TB.quantize(TB.init_params(cfg, 1, torch.float32, "cpu"), int4)
            return TB, cfg, int4, params, bf
        qcfg = {"W8A8": QuantConfig(type="int8"), "fp8 e4m3": fp8, "bf16": None}[fmt]
        return TB, cfg, qcfg, draw_baichuan(cfg, fmt, 1, "cpu"), bf
    cfg = TM.MixtralConfig(**MIXTRAL)
    if fmt == "int4":
        params = TM.quantize(TM.init_params(cfg, 1, torch.float32, "cpu"), int4)
        return TM, cfg, int4, params, bf
    qcfg = {"W8A8": QuantConfig(type="int8"), "fp8 e4m3": fp8, "float": None}[fmt]
    return TM, cfg, qcfg, draw_mixtral(cfg, fmt, 1, "cpu"), bf


def _ids(cfg, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)))


def _run(mod, cfg, qcfg, params, dtype):
    """(prefill logits, a cached prefill's hidden state, the next decode
    step's logits) of the model."""
    ids = _ids(cfg)
    with torch.inference_mode():
        h, _ = mod.forward(params, ids, cfg, qcfg, compute_dtype=dtype)
        cache = mod.init_kv_cache(cfg, B, 2 * T, dtype, "cpu")
        hc, _ = mod.forward(params, ids, cfg, qcfg, kv_cache=cache, cache_index=0,
                            compute_dtype=dtype)
        step, _ = mod.forward(params, ids[:, -1:], cfg, qcfg, kv_cache=cache, cache_index=T,
                              compute_dtype=dtype)
        return mod.logits(params, h), hc, mod.logits(params, step)


FORWARDS = ([("llama", f) for f in ("W8A8", "W8A8 fused", "W8A8 f32", "W8A8 per-token", "fp8",
                                     "int4", "bf16", "bf16 fused", "f32")]
            + [("gemma", f) for f in ("W8A8", "bf16")]
            + [("baichuan", f) for f in ("W8A8", "fp8 e4m3", "int4", "bf16")]
            + [("mixtral", f) for f in ("W8A8", "fp8 e4m3", "int4", "float")])


@pytest.mark.parametrize("family,fmt", FORWARDS, ids=[f"{a}-{b}" for a, b in FORWARDS])
def test_the_fold_moves_nothing(family, fmt, old_ops):
    """Prefill and decode logits (and the cached prefill's hidden state) of
    the folded forward bit-equal to the old ops'."""
    mod, cfg, qcfg, params, dtype = _model(family, fmt)
    new = _run(mod, cfg, qcfg, params, dtype)
    old_ops()
    old = _run(mod, cfg, qcfg, params, dtype)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


def test_capture_keeps_its_ops_and_statistics(old_ops):
    """Calibration capture runs the adds and norms as torch ops: its
    statistics and hidden state are the old ops' bit for bit."""
    mod, cfg, _, params, _ = _model("llama", "f32")
    with torch.inference_mode():
        h, _, stats = mod.forward(params, _ids(cfg), cfg, None, capture_stats=True)
        old_ops()
        h_old, _, stats_old = mod.forward(params, _ids(cfg), cfg, None, capture_stats=True)
    assert torch.equal(h, h_old)
    assert stats.keys() == stats_old.keys()
    assert all(torch.equal(stats[k], stats_old[k]) for k in stats)


def _stage_rank(cases):
    """One of 2 ranks at stage 2: each case's pipelined forward (one
    microbatch: the whole batch, the old ops' shapes) over this rank's
    layers; the hidden state on the last stage, None on the first."""
    import importlib

    from autosmoothquant_tpu_torch.shard.mesh import axis_of, make_mesh
    from autosmoothquant_tpu_torch.shard.pipeline import pipelined_forward, stage_stack

    mesh = make_mesh(stage=2, devices=["cpu"] * 2)
    index = axis_of(mesh, "stage").index
    out = {}
    with torch.inference_mode():
        for name, (mod_name, cfg, qcfg, params, ids, dtype) in cases.items():
            mod = importlib.import_module(mod_name)
            mine = {**params, "layers": stage_stack(params["layers"], 2)[index]}
            out[name] = pipelined_forward(mod, mine, ids, cfg, qcfg, mesh=mesh, microbatches=1,
                                          compute_dtype=dtype)
    return out


STAGE_CASES = [("llama", "W8A8"), ("llama", "fp8"), ("llama", "bf16"), ("baichuan", "W8A8"),
               ("mixtral", "W8A8")]


def test_two_stages_equal_the_old_ops(old_ops):
    """The 2-stage pipeline (stage 0 sends the completed sum, stage 1 folds
    its layers' adds and the final norm's): the last stage's hidden state
    bit-equal to the old ops' one-rank forward."""
    from autosmoothquant_tpu_torch.shard.mesh import launch

    cases = {}
    for family, fmt in STAGE_CASES:
        mod, cfg, qcfg, params, dtype = _model(family, fmt)
        cases[f"{family} {fmt}"] = (mod.__name__, cfg, qcfg, params, _ids(cfg, 9), dtype)
    ranks = launch(_stage_rank, 2, cases, threads=1, timeout=600)
    old_ops()
    for name, (mod_name, cfg, qcfg, params, ids, dtype) in cases.items():
        import importlib

        mod = importlib.import_module(mod_name)
        with torch.inference_mode():
            want = mod.forward(params, ids, cfg, qcfg, compute_dtype=dtype)[0]
        assert ranks[0][name] is None
        # a rank's tensors come back as numpy, bf16 widened to f32 (exact)
        assert torch.equal(torch.as_tensor(ranks[1][name]), want.float()), name
