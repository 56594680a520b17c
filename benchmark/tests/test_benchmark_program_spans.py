"""The traced run hands the program's spans and counters to the readers: the harness
sets the trainer's tracer for the window alone, joins what it recorded to the
profiler's trace (``stages``), and names the idle gaps by the program's stages. An
untraced run never makes a tracer.

On the CPU no operation runs on a device, so the profiler stands in here for the
card's: its trace holds, for each stage span that the program recorded on the
trainer's thread, one kernel on a compute stream launched inside that span, and in
the step whose NMS scans the program counted, one K3 kernel (``nms_keep_kernel``),
whose launch the step's ``k3.launches`` counter then counts, as the card's would."""

import json
import os
import threading
import time

import pytest

import tiny
from harness import runner, stages
from harness.cells import load_cell
from probabilisticteacher_torch import tracing
from probabilisticteacher_torch.engine import trainer as trainer_mod

REPO = tiny.REPO
SEED = 2 ** 32 + 99
READERS = ("teacher_ms", "augment_ms", "student_fwd_ms", "student_bwd_ms",
           "enqueue_idle_share", "enqueue_idle_loader_share", "decode_ms_per_img",
           "k3_roofline")
COMPUTE = 7


class SpanProfile:
    """``torch.profiler.profile`` on the CPU, with the trace described above."""

    tracers = []

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        tracer = self.tracers[-1]
        main = threading.get_native_id()
        with tracer._lock:
            spans = [s for s in tracer._spans if s.thread == main]
            counted = {c.iteration for c in tracer._counters if c.name == "k3.ious"}
            tracer._counters[:] = [c._replace(value=1) if c.name == "k3.launches"
                                   and c.iteration in counted else c
                                   for c in tracer._counters]
        base = min(s.start for s in spans) - 10 ** 6
        us = lambda t: (t - base) / 1e3  # noqa: E731
        events = []

        def kernel(name, s):
            mid = (s.start + s.end) // 2
            k = len(events)
            events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": COMPUTE,
                           "ts": us(mid), "dur": (s.end - mid) / 2e3,
                           "args": {"stream": COMPUTE, "correlation": k}})
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "pid": 1, "tid": 1, "ts": us(mid - 1000), "dur": 0.5,
                           "args": {"correlation": k}})

        for s in spans:
            if s.name in stages.STAGES:
                kernel(f"stage_kernel_{s.name}", s)
            if s.name == "forward" and s.iteration in counted:
                kernel("void nms_keep_kernel<false>(float4 const*)", s)
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": base, "traceEvents": events}, f)


@pytest.fixture
def watched(monkeypatch):
    """Every Tracer made, and every value given to a trainer's ``tracer``."""
    made, given = [], []

    class Watched(tracing.Tracer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    prop = trainer_mod.PTrainer.tracer

    def setter(self, value):
        given.append(value)
        prop.fset(self, value)

    monkeypatch.setattr(tracing, "Tracer", Watched)
    monkeypatch.setattr(trainer_mod.PTrainer, "tracer", property(prop.fget, setter))
    monkeypatch.setattr(SpanProfile, "tracers", made)
    monkeypatch.setattr("torch.profiler.profile", SpanProfile)
    return made, given


def _cell(tmp_path, phase):
    path, name = tiny.add_tiny_cell(str(tmp_path), phase, amp=False, native=False)
    return load_cell(path, name, os.path.join(str(tmp_path), "benchmark"))


@pytest.mark.parametrize("phase", ["mutual", "burnin"])
def test_a_traced_run_reads_the_program_spans(tmp_path, watched, phase):
    made, given = watched
    cell = _cell(tmp_path, phase)
    res = runner.run_program(cell, REPO, SEED, 1.0, True, "cpu", time.time_ns())
    # a tracer for the window alone
    assert len(made) == 1 and given == [made[0], None]
    st = res["stages"]
    assert st["iterations"] == res["iterations"] >= 1
    assert st["compute_stream"] == COMPUTE and st["ious"] > 0
    assert sum(st["map_n"].values()) > 0
    # every cell lists the eight readers; in burn-in teacher_ms finds no teacher
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    line = runner.per_layer(cell, res)
    want = [r for r in READERS if phase == "mutual" or r != "teacher_ms"]
    assert [r for r in READERS if r in line] == want
    assert all(line[r]["value"] > 0 for r in want)
    # the idle gaps are named by the program's spans, inside the benchmark's own
    names = {n for n, _ in res["trace"]["idle_gaps"]}
    assert names and names <= {"step", "data", "next(batch_iter)", "run_step",
                               "metrics fetch", "other", *stages.STAGES}
    assert names & {"step", "data", *stages.STAGES}


def test_an_untraced_run_makes_no_tracer(tmp_path, watched):
    made, given = watched
    cell = _cell(tmp_path, "burnin")
    res = runner.run_program(cell, REPO, SEED, 0.5, False, "cpu", time.time_ns())
    assert made == [] and given == []
    assert res["stages"] is None and res["trace"] is None
