"""The Gemma family of the port (``models/gemma.py``: the Llama module with
the load-time folds of ``convert/hf.py:gemma_params_from_state_dict``; head
dim 256 in K3 and decode attention) against the JAX package's, on the CPU:
a tiny Gemma (2 layers, hidden 128, 2 query heads and 1 kv head of 256,
gelu-tanh) whose params come from a random HF state dict through each
package's mapper.

Tolerances: the mappers' params within rtol 1e-6 (the same f32 folds); K3's
plain version at D 256 within 2e-6 of JAX's Pallas kernel (interpret mode),
decode attention's within 2e-6 of JAX's XLA attend; logits (std ~0.5) float
1e-5, int8 5e-2 (tests/test_torch_llama.py's 3e-2 at std 0.3, scaled);
greedy tokens equal (float), W8A8 up to the first near-tie (top-2 margin <=
0.02); the port's int8 pipeline KL(float || W8A8) < 5e-3, as JAX's
tests/test_gemma.py holds its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autosmoothquant_tpu.models import gemma as JG
from autosmoothquant_tpu.quant.config import QuantConfig as JQ
from autosmoothquant_tpu_torch.convert.from_jax import params_from_jax
from autosmoothquant_tpu_torch.kernels import attention as A
from autosmoothquant_tpu_torch.models import gemma as TG
from autosmoothquant_tpu_torch.quant.config import QuantConfig as TQ

from test_torch_quantize import leaves
from test_torch_util import (one_torch_thread, run_jax_cached,  # noqa: F401
                             run_port_cached, to_numpy_tree)

HF = {"architectures": ["GemmaForCausalLM"], "model_type": "gemma", "vocab_size": 512,
      "hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
      "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 256,
      "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
      "hidden_act": "gelu", "hidden_activation": "gelu_pytorch_tanh"}
NEAR_TIE = 0.02


def _hf_state_dict(seed=0):
    """A random HF Gemma state dict (numpy f32, [out, in] weights, norm
    weights around 0 as Gemma stores them, no lm_head: tied)."""
    rng = np.random.default_rng(seed)
    D, I, V, L = HF["hidden_size"], HF["intermediate_size"], HF["vocab_size"], 2
    Q, KV = 2 * 256, 256
    sd = {"model.embed_tokens.weight": 0.05 * rng.normal(size=(V, D)),
          "model.norm.weight": 0.1 * rng.normal(size=D)}
    for i in range(L):
        b = f"model.layers.{i}"
        sd.update({f"{b}.input_layernorm.weight": 0.1 * rng.normal(size=D),
                   f"{b}.post_attention_layernorm.weight": 0.1 * rng.normal(size=D),
                   f"{b}.self_attn.q_proj.weight": rng.normal(size=(Q, D)) / np.sqrt(D),
                   f"{b}.self_attn.k_proj.weight": rng.normal(size=(KV, D)) / np.sqrt(D),
                   f"{b}.self_attn.v_proj.weight": rng.normal(size=(KV, D)) / np.sqrt(D),
                   f"{b}.self_attn.o_proj.weight": rng.normal(size=(D, Q)) / np.sqrt(Q),
                   f"{b}.mlp.gate_proj.weight": rng.normal(size=(I, D)) / np.sqrt(D),
                   f"{b}.mlp.up_proj.weight": rng.normal(size=(I, D)) / np.sqrt(D),
                   f"{b}.mlp.down_proj.weight": rng.normal(size=(D, I)) / np.sqrt(I)})
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def gemma():
    """(JAX cfg, port cfg, JAX params, port params from the port's mapper)."""
    from autosmoothquant_tpu.convert.hf import gemma_params_from_state_dict as jmap
    from autosmoothquant_tpu_torch.convert.hf import load_hf_params

    sd = _hf_state_dict()
    cfg, tcfg = JG.LlamaConfig.from_hf(HF), TG.config_from_hf(HF)
    jp = jmap(sd, 2)
    tp = load_hf_params({k: torch.from_numpy(v) for k, v in sd.items()}, "gemma", 2,
                        device="cpu")
    return cfg, tcfg, jp, tp


def test_registry_and_config():
    from autosmoothquant_tpu_torch.models.registry import get_model_family

    assert get_model_family(HF) is TG and TG.FAMILY == "gemma"
    assert get_model_family({"model_type": "gemma"}) is TG
    cfg = TG.config_from_hf(HF)
    assert (cfg.head_dim, cfg.hidden_act, cfg.num_key_value_heads) == (256, "gelu_tanh", 1)
    assert cfg == TG.LlamaConfig(**{k: getattr(JG.LlamaConfig.from_hf(HF), k)
                                    for k in cfg.__dataclass_fields__})


def test_mapper_folds_match_jax(gemma):
    """The port's mapper against JAX's on the same state dict: norms 1 + w,
    the embedding times sqrt(128), the tied lm_head from the unscaled
    embedding (so lm_head^T * sqrt(hidden) = embed)."""
    cfg, tcfg, jp, tp = gemma
    want = dict(leaves(params_from_jax(to_numpy_tree(jp), tcfg, device="cpu")))
    got = dict(leaves(tp))
    assert set(want) == set(got)
    for path, a in want.items():
        torch.testing.assert_close(got[path], a, rtol=1e-6, atol=1e-7, msg=path)
    torch.testing.assert_close(tp["lm_head"]["w"].t() * np.sqrt(128.0), tp["embed"]["w"],
                               rtol=1e-6, atol=1e-7)


def test_flash_attention_plain_head_dim_256_matches_jax_kernel():
    """K3's plain version at D 256 (Gemma's heads, G = 2) against JAX's
    Pallas flash kernel in interpret mode, T 128, causal."""
    from autosmoothquant_tpu.kernels.attention import flash_attention as jflash

    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 128, 2, 256)).astype(np.float32)
    k, v = (rng.normal(size=(1, 128, 1, 256)).astype(np.float32) for _ in range(2))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=1 / 16,
                             causal=True, interpret=True))
    got = A.flash_attention(*map(torch.from_numpy, (q, k, v)), sm_scale=1 / 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_decode_attention_plain_head_dim_256_matches_jax():
    """Decode attention's plain version at D 256, G 4, rows at their own
    positions, against JAX attend at T = 1."""
    from autosmoothquant_tpu.models.common import attend

    rng = np.random.default_rng(1)
    b, s = 3, 40
    q = rng.normal(size=(b, 1, 4, 256)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, 1, 256)).astype(np.float32) for _ in range(2))
    pos = np.array([39, 12, 0])
    mask = (np.arange(s)[None, :] <= pos[:, None])[:, None, None, :]
    want = np.asarray(attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), 1 / 16))[:, 0]
    got = A.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos), scale=1 / 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def _quantized(gemma, qkw):
    """(JAX, port) params and configs of the int8 model JAX's pipeline makes."""
    from autosmoothquant_tpu.convert.pipeline import calibrate_smooth_quantize

    cfg, tcfg, jp, _ = gemma
    rng = np.random.default_rng(1)
    calib = [rng.integers(1, 512, size=(2, 16)).astype(np.int32) for _ in range(2)]
    jq, _ = calibrate_smooth_quantize(JG, jp, cfg, JQ(**qkw), lambda: iter(calib))
    return jq, params_from_jax(to_numpy_tree(jq), tcfg, device="cpu")


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_forward_matches_jax(gemma, quant):
    """Prefill (2 x 24) and one decode step, f32 KV cache, logits."""
    cfg, tcfg, jp, tp = gemma
    qcfg = tq = None
    if quant == "int8":
        qcfg, tq = JQ(type="int8"), TQ(type="int8")
        jp, tp = _quantized(gemma, {"type": "int8"})
    ids = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    j_pre, j_dec, tok = run_jax_cached(JG, cfg, jp, qcfg, ids, jnp.float32)
    t_pre, t_dec = run_port_cached(TG, tcfg, tp, tq, ids, torch.float32, tok)
    tol = 1e-5 if quant == "float" else 5e-2
    np.testing.assert_allclose(t_pre, j_pre, atol=tol, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=tol, rtol=0)


def test_int8_pipeline_kl(gemma):
    """The port's calibrate -> smooth -> quantize on the mapped Gemma:
    KL(float || W8A8) of the last token under 5e-3."""
    from autosmoothquant_tpu_torch.convert.pipeline import calibrate_smooth_quantize

    cfg, tcfg, jp, tp = gemma
    rng = np.random.default_rng(1)
    calib = [rng.integers(1, 512, size=(2, 16)).astype(np.int32) for _ in range(2)]
    qcfg = TQ(type="int8")
    qp, _ = calibrate_smooth_quantize(TG, tp, tcfg, qcfg, lambda: iter(calib))
    ids = torch.from_numpy(rng.integers(1, 512, size=(2, 24))).long()
    lp = torch.log_softmax(TG.logits(tp, TG.forward(tp, ids, tcfg)[0])[:, -1], -1)
    lq = torch.log_softmax(TG.logits(qp, TG.forward(qp, ids, tcfg, qcfg)[0])[:, -1], -1)
    kl = float((lp.exp() * (lp - lq)).sum(-1).mean())
    assert kl < 5e-3, kl


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_engine_greedy_equals_jax(gemma, quant):
    """Engine.generate on ragged prompts (unpadded, and left-padded in one
    batch): JAX's greedy tokens; W8A8 up to the first near-tie."""
    from autosmoothquant_tpu.serve import engine as JE
    from autosmoothquant_tpu_torch.serve import engine as TE

    cfg, tcfg, jp, tp = gemma
    qcfg = tq = None
    if quant == "int8":
        qcfg, tq = JQ(type="int8"), TQ(type="int8")
        jp, tp = _quantized(gemma, {"type": "int8"})
    prompts = [[5, 9, 1, 77, 3, 8, 100, 12, 40] * 2, [7, 7, 2] * 4, [300, 1, 2, 3]]
    je = JE.Engine(JG, jp, cfg, qcfg, max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    te = TE.Engine(TG, tp, tcfg, tq, max_batch=4, max_seq=64, kv_dtype=torch.float32,
                   compute_dtype=torch.float32, device="cpu")
    got = te.generate(prompts, TE.GenerationConfig(max_new_tokens=10))
    want = je.generate(prompts, JE.GenerationConfig(max_new_tokens=10))
    if quant == "float":
        assert got == want
        return
    for prompt, a, b in zip(prompts, got, want):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            h, _, _ = JG.forward_jit(jp, jnp.asarray([prompt + b[:j]], jnp.int32), cfg, qcfg)
            top = np.sort(np.asarray(JG.logits(jp, h))[0, -1])[-2:]
            assert float(top[1] - top[0]) <= NEAR_TIE, (j, a, b)


def test_smoothquant_cli_to_served_artifact(tmp_path, capsys):
    """An HF Gemma checkpoint (tied head, head dim 256) through the
    smoothquant_model CLI: an artifact that both packages' loaders read to
    the same arrays, served by test_model with the static engine's greedy
    tokens over the loaded params."""
    from autosmoothquant_tpu.convert.pipeline import load_any_quantized as jload
    from autosmoothquant_tpu_torch.cli import load
    from autosmoothquant_tpu_torch.serve.engine import Engine, GenerationConfig

    from test_torch_baichuan import run_cli_and_serve, write_hf_dir

    (tmp_path / "hf").mkdir()
    hf_dir = write_hf_dir(tmp_path / "hf", HF, _hf_state_dict(), HF["vocab_size"])
    art, served = run_cli_and_serve(hf_dir, tmp_path / "out", capsys)
    model, family, cfg, params, qcfg = load(str(art), "cpu")
    assert model is TG and family == "gemma" and cfg.head_dim == 256
    jparams, _, _ = jload(str(art))
    want = dict(leaves(params_from_jax(to_numpy_tree(jparams), cfg, device="cpu")))
    for path, a in leaves(params):
        assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path
    eng = Engine(TG, params, cfg, qcfg, max_batch=1, max_seq=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cpu")
    assert served == eng.generate([[7, 12, 9, 101]], GenerationConfig(max_new_tokens=4))[0]
