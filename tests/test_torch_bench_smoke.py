"""``python -m probabilisticteacher_torch.bench --smoke`` end to end on the CPU: the
worker, the warm start and the loader-in-the-loop run, each a child process, and
one JSON line with every key of the record on standard output."""

import json
import os
import subprocess
import sys

import pytest

from probabilisticteacher_torch import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "windows", "window_min",
               "window_max", "spread", "compile_s", "compile_warm_s", "batch", "e2e", "device",
               "images_rule", "step_ms", "conv_tflop_per_iter", "conv_mfu"}


def test_smoke_end_to_end_prints_one_record(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    # keep TensorBoard's import (which pulls in TensorFlow here) out of the e2e trainer
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), REPO]), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "probabilisticteacher_torch.bench", "--smoke",
                          "--data-root", str(tmp_path / "proxy")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert RECORD_KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["conv_mfu"] is None and rec["batch"] == 2
    assert rec["value"] > 0 and rec["step_ms"] == pytest.approx(8 / rec["value"] * 1e3, rel=1e-3)
    assert rec["conv_tflop_per_iter"] == round(roofline.iteration(48, 96, 2, depth=11)["flops"]
                                               / 1e12, 3)
    assert 0.0 <= rec["e2e"]["data_time_share"] <= 1.0 and rec["e2e"]["value"] > 0
    assert rec["e2e"]["step_alone_ms"] > 0
    assert rec["compile_warm_s"] > 0

