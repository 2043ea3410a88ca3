"""The port's bench arm (``python -m autosmoothquant_tpu_torch.bench``) on the
CPU at ``bench.py``'s 2-layer ``tiny`` preset: one JSON line with
``bench.py``'s keys, the metric spelled from the preset and batch; and its
presets against ``bench.py``'s own."""

import json
import os
import subprocess
import sys

import pytest

from autosmoothquant_tpu_torch import bench as TB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_prints_one_json_line_with_bench_keys(batch):
    env = {**os.environ, "PYTHONPATH": ROOT, "ASQ_BENCH_PRESET": "tiny",
           "ASQ_BENCH_BATCH": str(batch), "ASQ_BENCH_PROMPT": "16", "ASQ_BENCH_SMAX": "96"}
    proc = subprocess.run([sys.executable, "-m", "autosmoothquant_tpu_torch.bench",
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == f"decode_tok_per_s_w8a8_int8_tiny_b{batch}"
    assert out["unit"] == "tok/s" and out["device"] == "cpu"
    assert out["value"] > 0 and out["bf16_tok_per_s"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / out["bf16_tok_per_s"], rel=1e-2)


@pytest.mark.parametrize("preset", ["tiny", "tinyllama", "llama7b", "llama13b"])
def test_presets_are_bench_py_s(preset):
    import bench as JB

    jcfg = JB.get_cfg(preset)
    for k, v in TB.PRESETS[preset].items():
        assert getattr(jcfg, k) == v, k
    assert TB.get_cfg(preset).head_dim == jcfg.head_dim


def test_bench_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="preset"):
        TB.get_cfg("llama70b")
    with pytest.raises(ValueError, match="s_max"):
        TB.run("tiny", 1, 128, 128, "cpu")
