"""The harness on the CPU: cells found by name, a cell added by data alone, the result
line's keys, the end-to-end metrics over the whole window, and no JAX anywhere."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

import tiny
from harness import runner
from harness.cells import BENCH_DIR, load_cell, metric_reader

REPO = os.path.dirname(BENCH_DIR)
BANNED = {"jax", "jaxlib", "flax", "probabilisticteacher_tpu"}


def test_every_cell_of_the_benchmark_resolves_to_its_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = load_cell(os.path.join(REPO, "BENCHMARK.json"), w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"train_img_s", "setup_s"}
        assert cell.per_layer and all(m["moves"] == "train_img_s" for m in cell.per_layer)
        for m in cell.per_layer:
            assert callable(metric_reader(cell.bench_dir, m["name"]))
        assert cell.limits
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))


@pytest.mark.parametrize("name", ["pt_vgg16_c2f", "pt_vgg16_k2c"])
def test_configuration_file_describes_what_the_program_runs(name, tmp_path):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    w = next(w for w in spec["workloads"] if w["config"] == name)
    cell = load_cell(os.path.join(REPO, "BENCHMARK.json"), w["name"])
    from probabilisticteacher_torch.solver import auto_scale_config
    cfg = auto_scale_config(runner.program_cfg(cell, REPO, 1, str(tmp_path), "cpu"))
    assert runner.config_mismatches(cell, cfg) == []
    cell.config["arch"]["fc_dim"] = 512
    assert runner.config_mismatches(cell, cfg) == ["arch.fc_dim: file 512, program 1024"]


def test_a_cell_added_as_data_alone_runs_and_prints_the_contract_line(tmp_path):
    path, name = tiny.add_tiny_cell(str(tmp_path), "mutual", amp=False, native=False)
    bench = os.path.join(str(tmp_path), "benchmark")
    cell = load_cell(path, name, bench)
    assert cell.config["name"] == "tiny_pt_vgg16_c2f" and cell.traffic["phase"] == "mutual"
    line = runner.run_cell(cell, REPO, 2 ** 31 + 5, 1.0, False, "cpu", time.time_ns())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_img_s", "peak_mem_gib", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"batch", "loss", "rpn_first", "rpn_out_first", "grad",
                                   "delta", "delta_median", "pseudo_miss", "teacher_delta"}
    json.dumps(line, allow_nan=False)


def test_train_img_s_is_every_image_of_the_window_over_all_its_time():
    res = {"images": (16 + 16) * 61, "window_s": 30.5, "peak_bytes": 12 * 2 ** 30,
           "setup_s": 25.0}
    e2e = runner.end_to_end(res)
    assert e2e["train_img_s"] == pytest.approx(32 * 61 / 30.5)
    assert e2e["peak_mem_gib"] == 12.0 and e2e["setup_s"] == 25.0


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_benchmark_source_imports_jax_and_the_reference_imports_no_program():
    for root, _, files in os.walk(BENCH_DIR):
        if ".cache" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(root, f))}
                assert not tops & BANNED, (f, tops & BANNED)
                if os.path.basename(root) == "reference":
                    assert "probabilisticteacher_torch" not in tops, f


def test_a_run_loads_no_module_of_jax(tmp_path):
    """A tiny run in a fresh process, then ``sys.modules`` by whole top-level names."""
    code = f"""
import os, sys, time
sys.path[:0] = [{os.path.dirname(__file__)!r}, {BENCH_DIR!r}, {REPO!r}]
sys.modules["torch.utils.tensorboard"] = None
import tiny
from harness import runner
from harness.cells import load_cell
path, name = tiny.add_tiny_cell({str(tmp_path)!r}, "burnin", amp=False, native=False)
cell = load_cell(path, name, os.path.join({str(tmp_path)!r}, "benchmark"))
runner.run_cell(cell, {REPO!r}, 11, 0.5, False, "cpu", time.time_ns())
print("BANNED", runner.banned_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "probabilisticteacher_tpu_like", object())
    assert runner.banned_modules() == sorted(BANNED & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in runner.banned_modules()

