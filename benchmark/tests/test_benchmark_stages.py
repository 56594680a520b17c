"""``harness/stages.py`` and the readers of the program's spans on a small trace: two
steps of known stages, launch records from the main thread and from autograd's
thread, a side stream of prefetch copies, known idle gaps, and the loader's spans."""

import collections
import random

import pytest

from harness import stages, trace
from harness.cells import BENCH_DIR, metric_reader

BASE = 1_790_000_000_000_000_000
MAIN, AUTOGRAD, PREFETCH, LOADER, BATCH = 100, 101, 200, 300, 301
COMPUTE, SIDE = 7, 9

Span = collections.namedtuple("Span", "id name start end thread iteration parent tag")
Counter = collections.namedtuple("Counter", "name iteration value time")


def ns(t_us):
    return BASE + int(t_us * 1000)


def _spans():
    out = []

    def add(name, a, b, thread=MAIN, it=5, tag=""):
        out.append(Span(len(out), name, ns(a), ns(b), thread, it, -1, tag))

    add("step", 0, 600)
    for name, a, b in (("data", 0, 100), ("ema", 100, 150), ("pseudo_labels", 150, 250),
                       ("augment", 250, 300), ("forward", 300, 400), ("backward", 400, 550),
                       ("optimizer", 550, 580)):
        add(name, a, b)
    add("step", 700, 950, it=6)
    for name, a, b in (("data", 700, 800), ("augment", 800, 850), ("forward", 850, 900),
                       ("backward", 900, 930), ("optimizer", 930, 940)):
        add(name, a, b, it=6)
    add("prefetch.wait", 50, 120, PREFETCH)
    add("prefetch.copy", 120, 160, PREFETCH)
    add("loader.map", 20, 70, LOADER, tag="l")
    add("loader.map", 500, 640, LOADER, tag="u")
    add("loader.map", 1200, 1300, LOADER, tag="u")      # after the window
    add("loader.map", 990, 1400, LOADER, tag="l")       # not over by the window's end
    add("loader.batch", 10, 680, BATCH)
    return out


# (launching thread, launch us, stream, start us, end us, kernel name)
OPS = [(MAIN, 110, COMPUTE, 115, 140, "ema_kernel"),
       (MAIN, 160, COMPUTE, 160, 240, "teacher_conv"),
       (PREFETCH, 130, SIDE, 130, 150, "Memcpy HtoD (Pinned -> Device)"),
       (MAIN, 260, COMPUTE, 260, 290, "aug_kernel"),
       (MAIN, 310, COMPUTE, 310, 390, "void nms_keep_kernel<false>(float4 const*)"),
       (AUTOGRAD, 420, COMPUTE, 420, 530, "dgrad"),
       (MAIN, 560, COMPUTE, 560, 575, "sgd"),
       (MAIN, 590, COMPUTE, 590, 595, "metrics_stack"),
       (MAIN, 860, COMPUTE, 860, 895, "void nms_keep_kernel<false>(float4 const*)"),
       (AUTOGRAD, 905, COMPUTE, 905, 925, "wgrad"),
       (MAIN, 935, COMPUTE, 935, 938, "sgd")]


def _trace():
    events = []
    for i, (tid, launch, stream, a, b, name) in enumerate(OPS):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": a,
                       "dur": b - a, "args": {"stream": stream, "correlation": 40 + i}})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "pid": 4242, "tid": 7_000_000 + tid, "ts": launch, "dur": 2.0,
                       "args": {"correlation": 40 + i}})
    return {"baseTimeNanoseconds": BASE, "traceEvents": events}


# the IoUs of iteration 4 (before the window) and 5 (the first step in it) counted
COUNTERS = [Counter("k3.ious", 4, 99, 0), Counter("k3.ious", 5, 1000, 0),
            Counter("prefetch.depth", 5, 1, 0), Counter("k3.launches", 4, 3, 0),
            Counter("k3.launches", 5, 1, 0), Counter("k3.launches", 6, 1, 0)]


def _summary():
    return stages.summarize(_trace(), _spans(), COUNTERS, ns(0), ns(1000), MAIN)


def test_device_time_by_stage_on_the_compute_stream():
    s = _summary()
    assert s["compute_stream"] == COMPUTE and s["iterations"] == 2
    want = {"ema": 25, "pseudo_labels": 80, "augment": 30, "forward": 80 + 35,
            "backward": 110 + 20, "optimizer": 15 + 3, "step": 5}
    assert s["device_s"] == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert s["other_streams_s"] == pytest.approx({"prefetch.copy": 20e-6})
    assert s["compute_busy_s"] == pytest.approx(403e-6)
    assert (s["launches"], s["launches_in_step"]) == (10, 10)
    assert s["ious"] == 1000          # iteration 5; 4 ended before the window
    # iteration 5's operations: its K3 kernel and the others it launched; not 6's
    assert s["counted_kernels"] == {
        "void nms_keep_kernel<false>(float4 const*)": [pytest.approx(80e-6), 1],
        **{n: [pytest.approx(d * 1e-6), 1] for n, d in (
            ("ema_kernel", 25), ("teacher_conv", 80), ("aug_kernel", 30), ("dgrad", 110),
            ("sgd", 15), ("metrics_stack", 5))}}
    assert s["counted_k3_launches"] == 1


def test_idle_time_partitions_by_what_the_host_was_doing():
    s = _summary()
    assert s["idle_data_s"] == pytest.approx(200e-6)
    assert s["idle_enqueue_s"] == pytest.approx(237e-6)
    assert s["idle_other_s"] == pytest.approx(150e-6)
    # under a prefetch.copy (150-160) or a loader.map (530-560, 575-590, 595-600);
    # not under the loader.batch span, which is open all through step A
    assert s["idle_enqueue_host_s"] == pytest.approx(60e-6)
    # idle time under each main-thread span, steps A and B
    want = {"data": 100 + 100, "ema": 15, "pseudo_labels": 20, "augment": 20 + 50,
            "forward": 20 + 15, "backward": 40 + 10, "optimizer": 15 + 7, "step": 15 + 10}
    assert s["idle_by_span_s"] == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(s["idle_by_span_s"].values()) == pytest.approx(
        s["idle_data_s"] + s["idle_enqueue_s"])
    assert s["enqueue_s"] == pytest.approx((600 - 100 + 250 - 100) * 1e-6)
    assert s["enqueue_host_s"] == pytest.approx((160 - 120 + 600 - 500) * 1e-6)
    # the three parts add up to the idle time that trace.summarize counts
    whole = trace.summarize(trace.device_events(_trace()), ns(0), ns(1000))
    parts = s["idle_data_s"] + s["idle_enqueue_s"] + s["idle_other_s"]
    assert parts == pytest.approx(whole["window_s"] - whole["busy_s"], abs=1e-12)
    assert s["map_n"] == {"l": 1, "u": 1}
    assert s["map_s"] == pytest.approx({"l": 50e-6, "u": 140e-6})


def test_readers_of_the_program_spans():
    t = trace.summarize(trace.device_events(_trace()), ns(0), ns(1000))
    ctx = {"trace": t, "iterations": 2, "stages": _summary()}
    read = lambda n: metric_reader(BENCH_DIR, n)(ctx)  # noqa: E731
    assert read("teacher_ms") == pytest.approx((25 + 80) * 1e-3 / 2)
    assert read("augment_ms") == pytest.approx(30e-3 / 2)
    assert read("student_fwd_ms") == pytest.approx(115e-3 / 2)
    assert read("student_bwd_ms") == pytest.approx((130 + 18) * 1e-3 / 2)
    assert read("enqueue_idle_share") == pytest.approx(100 * 237 / 1000)
    assert read("enqueue_idle_loader_share") == pytest.approx(100 * 60 / 1000)
    assert read("decode_ms_per_img") == pytest.approx((50 + 140) * 1e-3 / 2)
    assert read("k3_roofline") == pytest.approx(100 * 1000 * 13 / 67e12 / 80e-6)
    stage_sum = sum(read(n) for n in ("teacher_ms", "augment_ms", "student_fwd_ms",
                                      "student_bwd_ms"))
    assert stage_sum == pytest.approx(398e-3 / 2)


@pytest.mark.parametrize("name", ["teacher_ms", "augment_ms", "student_fwd_ms",
                                  "student_bwd_ms", "enqueue_idle_share",
                                  "enqueue_idle_loader_share", "decode_ms_per_img",
                                  "k3_roofline"])
def test_readers_find_nothing_without_the_program_spans(name):
    """A program without the tracer (the parent of the change that added it) gives
    a run with no ``stages``: each reader returns None and does not raise."""
    t = trace.summarize(trace.device_events(_trace()), ns(0), ns(1000))
    read = metric_reader(BENCH_DIR, name)
    assert read({"trace": t, "iterations": 2}) is None
    assert read({"trace": None, "iterations": 2, "stages": None}) is None


def test_k3_roofline_needs_the_counted_launches_in_the_trace():
    """The IoUs of a launch that the trace lacks (or a K3 kernel in the trace whose
    IoUs were not counted) would skew the share: the reader then gives nothing."""
    t = trace.summarize(trace.device_events(_trace()), ns(0), ns(1000))
    extra = COUNTERS + [Counter("k3.launches", 5, 1, 0)]
    st = stages.summarize(_trace(), _spans(), extra, ns(0), ns(1000), MAIN)
    assert st["counted_k3_launches"] == 2
    assert metric_reader(BENCH_DIR, "k3_roofline")({"trace": t, "stages": st}) is None


def test_burn_in_has_no_teacher():
    spans = [s for s in _spans() if s.name not in ("ema", "pseudo_labels")]
    st = stages.summarize(_trace(), spans, COUNTERS, ns(0), ns(1000), MAIN)
    assert metric_reader(BENCH_DIR, "teacher_ms")({"stages": st}) is None
    # the teacher's launches now fall in the step's own time
    assert st["device_s"]["step"] == pytest.approx((5 + 25 + 80) * 1e-6)


def test_interval_arithmetic_against_points():
    rng = random.Random(3)

    def rand_set():
        return stages.union((a, a + rng.randint(1, 9)) for a in
                            (rng.randint(0, 90) for _ in range(rng.randint(0, 8))))

    def points(x):
        return {t for a, b in x for t in range(a, b)}

    for _ in range(300):
        x, y = rand_set(), rand_set()
        assert points(stages.intersect(x, y)) == points(x) & points(y)
        assert points(stages.subtract(x, y)) == points(x) - points(y)
        assert stages.length(x) == len(points(x))
