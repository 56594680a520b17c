"""The parse of a recorded profiler trace into device busy and idle time, kernel
times by name and the breakdown."""

import json
import os

import pytest

from harness import trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "trace_small.json")
BASE = 1_790_000_000_000_000_000


def us(t):
    return BASE + int(t * 1000)


def load():
    with open(DATA) as f:
        return trace.device_events(json.load(f))


def test_device_events_keep_device_operations_only():
    ev = load()
    assert len(ev) == 5
    assert all(a < b for _, a, b in ev)
    assert ev[0][1] == us(1000)


def test_summary_busy_idle_and_kernels():
    spans = [("run_step", us(0), us(9000)), ("next(batch_iter)", us(5000), us(8000)),
             ("metrics fetch", us(13000), us(19000))]
    s = trace.summarize(load(), us(0), us(20000), spans)
    # busy: [1000, 4500] + [10000, 13000] + [19000, 20000 (window end)]
    assert s["busy_s"] == pytest.approx((3500 + 3000 + 1000) * 1e-6)
    assert s["window_s"] == pytest.approx(0.02)
    assert 1 - s["busy_s"] / s["window_s"] == pytest.approx(0.625)
    sec, n = trace.kernel_time(s["kernels"], "roi_align_fwd_kernel")
    assert (sec, n) == (pytest.approx(0.004), 2)
    assert trace.kernel_time(s["kernels"], "roi_align_bwd_kernel") == (pytest.approx(0.0015), 1)
    assert trace.kernel_time(s["kernels"], "nms_keep_kernel") == (pytest.approx(0.003), 1)
    # each gap is named by the innermost span open where it begins
    assert s["idle_gaps"][0] == ["metrics fetch", pytest.approx(0.006)]
    assert s["idle_gaps"][1] == ["run_step", pytest.approx(0.0055)]
    assert s["idle_gaps"][2] == ["run_step", pytest.approx(0.001)]
    assert s["device_ops"][0][0].startswith("void roi_align_fwd_kernel")
    assert s["device_ops"][0][1] == pytest.approx(0.004)
    assert len(s["device_ops"]) == 4 and all(len(n) <= trace.NAME_CHARS for n, _ in s["device_ops"])


def test_metric_readers_on_the_summary():
    from harness.cells import metric_reader, BENCH_DIR
    s = trace.summarize(load(), us(0), us(20000), [])
    ctx = {"trace": s, "iterations": 1, "window_s": 0.02, "data_wait_s": 0.005,
           "flops_per_iter": 989e12 * 0.01, "peak_flops": 989e12,
           "launches": {"k1": [0.001, 0.0005], "k2": [0.0003]}}
    read = lambda n: metric_reader(BENCH_DIR, n)(ctx)  # noqa: E731
    assert read("device_idle_share") == pytest.approx(62.5)
    assert read("data_wait_share") == pytest.approx(25.0)
    assert read("step_mfu") == pytest.approx(50.0)
    assert read("k1_roofline") == pytest.approx(100 * 0.0015 / 0.004)
    assert read("k2_roofline") == pytest.approx(100 * 0.0003 / 0.0015)
    assert read("k3_ms_per_iter") == pytest.approx(3.0)
    assert metric_reader(BENCH_DIR, "k1_roofline")({"trace": None}) is None
    ctx["launches"] = {"k1": [0.001, 0.0005, 0.0001], "k2": [0.0003]}   # 2 launches, 3 a step
    assert read("k1_roofline") is None
