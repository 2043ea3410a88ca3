"""The port stands alone: importing every module of
``autosmoothquant_tpu_torch`` loads no JAX, no ml_dtypes, no safetensors, no
transformers or datasets (the quantize path reads checkpoints and
calibration text itself) and nothing of the JAX package
(``autosmoothquant_tpu`` and its submodules; the port's own name shares that
prefix, so the check matches whole names), and builds no kernel."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import autosmoothquant_tpu_torch as P
for mi in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    importlib.import_module(mi.name)
from autosmoothquant_tpu_torch.kernels import _build
banned = ("jax", "jaxlib", "ml_dtypes", "safetensors", "transformers", "datasets",
          "autosmoothquant_tpu")
print(json.dumps({
    "modules": sorted(m for m in sys.modules if m.startswith(P.__name__)),
    "banned": sorted(m for m in sys.modules if m.split(".")[0] in banned),
    "built": sorted(_build._libs),
}))
"""


def test_port_imports_no_jax_side_module():
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["banned"] == []
    assert out["built"] == []
    for name in ("quant.config", "quant.math", "kernels.gemm", "kernels.fused",
                 "kernels.attention", "kernels.fp8", "kernels.int4",
                 "convert.pipeline", "models.llama", "models.opt",
                 "models.registry", "serve.engine", "serve.sampling", "serve.batching",
                 "serve.paged",
                 "serve.api", "utils.tokenizer", "utils.sp_tokenizer", "cli.serve_model",
                 "cli.test_model", "cli.smoothquant_model", "calibrate.calibrate",
                 "convert.hf", "quant.smooth", "quant.ignore", "quant.fake_quant",
                 "utils.datautils", "eval.ppl", "eval.harness", "eval.tasks",
                 "eval.lm_adapter", "eval.lm_eval_adapter", "eval.custom_metrics",
                 "utils.chat", "utils.eval_utils", "utils.seed", "utils.profiling",
                 "cli.eval_model", "shard.mesh", "shard.sharding", "shard.pipeline",
                 "serve.multihost"):
        assert f"autosmoothquant_tpu_torch.{name}" in out["modules"]


def test_chip_smoke_imports_no_jax_side_module():
    """chip_smoke.py at import (its phases import only the port)."""
    probe = ("import sys, json; sys.argv = ['chip_smoke']; import chip_smoke; "
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
             "in ('jax', 'jaxlib', 'ml_dtypes', 'autosmoothquant_tpu'))))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _run_smoke(cwd):
    return subprocess.run([sys.executable, os.path.join(cwd, "chip_smoke.py")],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: a nonzero exit and no result line; the same alone in a
    directory without the package."""
    import shutil

    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
