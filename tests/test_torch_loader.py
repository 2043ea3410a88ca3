"""The port reads the artifact the JAX package writes: its own safetensors
reader gives the bytes JAX's loader gives, and ``load_quantized`` gives the
tensors that carrying JAX's loaded params over gives, byte for byte."""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.convert import fast_loader as JFL
from autosmoothquant_tpu.convert import pipeline as JP
from autosmoothquant_tpu_torch.convert import pipeline as TP
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax, to_torch
from autosmoothquant_tpu_torch.convert.safetensors_io import load_safetensors

from test_torch_util import TINY, jax_llama, to_numpy_tree


def _bytes(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        elif a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            a = a.view(torch.uint8)
        return a.contiguous().numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def test_reader_matches_jax_for_every_dtype(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "i8": rng.integers(-128, 128, (3, 5)).astype(np.int8),
        "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
        "f32": rng.normal(size=(2, 3)).astype(np.float32),
        "bf16": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "u8": rng.integers(0, 256, (9,)).astype(np.uint8),
        "scalar": np.float32(2.5).reshape(()),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "t.safetensors")
    JFL.save_safetensors(path, arrays, metadata={"format": "asq"})
    ours, theirs = load_safetensors(path), JFL._load_safetensors_py(path)
    assert set(ours) == set(theirs) == set(arrays)
    expect = {"i8": torch.int8, "i32": torch.int32, "f32": torch.float32,
              "bf16": torch.bfloat16, "f16": torch.float16, "u8": torch.uint8,
              "scalar": torch.float32, "empty": torch.float32}
    for name, t in ours.items():
        assert t.dtype == expect[name]
        assert tuple(t.shape) == theirs[name].shape
        assert _bytes(t) == _bytes(theirs[name]), name


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A JAX-saved W8A8 artifact with bf16 embed/lm_head leaves."""
    JL, cfg, qp, qcfg = jax_llama({"type": "int8"})
    qp = dict(qp)
    qp["embed"] = {"w": qp["embed"]["w"].astype(jnp.bfloat16)}
    qp["lm_head"] = {"w": qp["lm_head"]["w"].astype(jnp.bfloat16)}
    path = str(tmp_path_factory.mktemp("asq") / "ckpt")
    JP.save_quantized(path, qp, qcfg, config_dict={**TINY, "model_type": "llama"})
    return path, cfg


def test_flat_artifact_is_byte_equal(artifact):
    path, _ = artifact
    ours = TP.read_artifact(path)
    theirs = JFL.load_safetensors(os.path.join(path, "asq_weights.safetensors"))
    assert set(ours) == set(theirs)
    assert ours["embed/w"].dtype == torch.bfloat16
    for k in ours:
        assert _bytes(ours[k]) == _bytes(theirs[k]), k


def test_load_quantized_matches_jax_load_carried_over(artifact):
    path, cfg = artifact
    params, qcfg, config = TP.load_quantized(path, device="cpu")
    jparams, jqcfg, jconfig = JP.load_quantized(path)
    assert qcfg.to_dict() == jqcfg.to_dict() and config == jconfig
    ref = params_from_jax(to_numpy_tree(jparams), device="cpu")

    _walk_equal(params, ref, cfg.num_hidden_layers)
    # layout of the carry-over: per-layer, int8 weights [out, in], f32 norms
    stacked = to_numpy_tree(jparams)["layers"]
    q0 = params["layers"][1]["attn"]["q"]
    assert q0["w"].dtype == torch.int8 and q0["w"].is_contiguous()
    np.testing.assert_array_equal(q0["w"].numpy(), stacked["attn"]["q"]["w"][1].T)
    assert q0["dequant_scale"].shape == ()
    assert params["layers"][0]["ln1"]["w"].dtype == torch.float32
    assert params["embed"]["w"].dtype == torch.bfloat16


def test_to_torch_reads_ml_dtypes_bf16_without_importing_it():
    a = np.asarray([1.5, -2.25, 3e38], dtype=ml_dtypes.bfloat16)
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == a.astype(np.float32).tolist()


def test_load_quantized_default_device_needs_a_card(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TP.load_quantized(artifact[0])


def _walk_equal(a, b, n_layers, where=""):
    """Same tree, dtypes, shapes and bytes."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _walk_equal(a[k], b[k], n_layers, f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b) == n_layers
        for i, (x, y) in enumerate(zip(a, b)):
            _walk_equal(x, y, n_layers, f"{where}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert _bytes(a) == _bytes(b), where


def test_reader_reads_fp8_like_jax(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {"e4m3": rng.normal(size=(6, 5)).astype(ml_dtypes.float8_e4m3fn),
              "e5m2": (rng.normal(size=(7,)) * 1e-5).astype(ml_dtypes.float8_e5m2)}
    path = str(tmp_path / "f8.safetensors")
    JFL.save_safetensors(path, arrays)
    ours, theirs = load_safetensors(path), JFL._load_safetensors_py(path)
    assert ours["e4m3"].dtype == torch.float8_e4m3fn
    assert ours["e5m2"].dtype == torch.float8_e5m2
    for name in arrays:
        assert tuple(ours[name].shape) == theirs[name].shape
        assert _bytes(ours[name]) == _bytes(theirs[name]), name


def test_to_torch_reads_ml_dtypes_fp8_without_importing_it():
    for mdt, tdt in ((ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
                     (ml_dtypes.float8_e5m2, torch.float8_e5m2)):
        a = np.asarray([1.5, -2.25, 0.001953125, 0.0], dtype=mdt)
        t = to_torch(a)
        assert t.dtype == tdt
        assert t.float().tolist() == a.astype(np.float32).tolist()


QUANT_FORMATS = {"fp8": {"type": "fp8_e4m3"},
                 "fp8_static": {"type": "fp8_e4m3", "activation_scheme": "static"},
                 "e5m2": {"type": "fp8_e5m2"},
                 "int4": {"type": "int4"}}


@pytest.fixture(scope="module", params=list(QUANT_FORMATS))
def artifact_fp8_int4(request, tmp_path_factory):
    JL, cfg, qp, qcfg = jax_llama(QUANT_FORMATS[request.param])
    path = str(tmp_path_factory.mktemp(f"asq_{request.param}") / "ckpt")
    JP.save_quantized(path, qp, qcfg, config_dict={**TINY, "model_type": "llama"})
    return path, cfg, request.param


def test_load_quantized_fp8_int4_matches_jax_load_carried_over(artifact_fp8_int4):
    """load_quantized of a JAX-saved fp8 or int4 artifact gives, byte for
    byte, what params_from_jax makes of JAX's own load; weights are [N, K]
    (int4: packed [N, K'/2] with w_scales [N, G])."""
    path, cfg, fmt = artifact_fp8_int4
    params, qcfg, config = TP.load_quantized(path, device="cpu")
    jparams, jqcfg, jconfig = JP.load_quantized(path)
    assert qcfg.to_dict() == jqcfg.to_dict() and config == jconfig
    _walk_equal(params, params_from_jax(to_numpy_tree(jparams), device="cpu"),
                cfg.num_hidden_layers)
    stacked = to_numpy_tree(jparams)["layers"]
    gate = params["layers"][1]["mlp"]["gate"]
    jgate = stacked["mlp"]["gate"]
    assert gate["w"].is_contiguous()
    np.testing.assert_array_equal(_bytes(gate["w"]), _bytes(jgate["w"][1].T.copy()))
    if fmt == "int4":
        assert gate["w"].dtype == torch.uint8
        np.testing.assert_array_equal(gate["w_scales"].numpy(), jgate["w_scales"][1].T)
    else:
        assert gate["w"].dtype == {"e5m2": torch.float8_e5m2}.get(fmt, torch.float8_e4m3fn)
        assert ("w_scale" in gate) == (fmt != "e5m2")
        assert ("input_scale" in gate) == (fmt == "fp8_static")
