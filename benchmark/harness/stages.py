"""Device time by stage of the training step, and the device's idle time by what the
host was doing, from a profiler trace and the program's own spans.

The program's tracer (``probabilisticteacher_torch/tracing.py``) records spans on
``time.time_ns()``, the clock of the trace's ``baseTimeNanoseconds``: on the main
thread a ``step`` span per iteration holding ``data`` and the stages (``ema``,
``pseudo_labels``, ``augment``, ``forward``, ``backward``, ``grad_all_reduce``,
``optimizer``); on the loader's threads ``loader.map`` and ``loader.batch``; on the
prefetcher's ``prefetch.wait`` and ``prefetch.copy``; per iteration the counter
``k3.launches``, and for the tracer's first step ``k3.ious``, the IoUs its NMS scans
needed (counted after the window, so the trace times the kernel that untraced runs
launch).

Each device operation is joined to the host through its launch record: the
trace's ``cuda_runtime`` (or ``cuda_driver``) event with the same
``correlation``, stamped on the same clock. An operation on the compute stream
belongs to the main-thread span open when its launch record was issued, on
whichever thread it was issued: autograd's device thread launches the backward
while the main thread waits in the ``backward`` span. The compute stream is the
stream that runs the most device time of the operations launched in stages; the
prefetcher's copies run on a side stream of their own, and an operation there
launched while a ``prefetch.copy`` span was open is that span's. (The launch
records' ``tid`` is CUPTI's thread handle, not the native thread id that the
spans carry, so the join goes by time and stream.)

Idle time is the window less the union of every device operation, as
``trace.summarize`` counts it, split three ways by the main thread: inside a
``step`` and outside its ``data`` (the host enqueues, or is held), inside ``data``
(the step waits for a batch), and elsewhere (the benchmark's own loop). The
enqueue's idle time is also split by whether another thread was doing host work
that holds the interpreter: a ``loader.map`` (read, decode, resize, crop, flip) or
a ``prefetch.copy`` (pin and enqueue). ``loader.batch`` and ``prefetch.wait`` are
left out: they are mostly waits, on the map threads and on the loader.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STAGES = ("ema", "pseudo_labels", "augment", "forward", "backward", "grad_all_reduce",
          "optimizer")
MAIN = ("step", "data") + STAGES
HOST_WORK = ("loader.map", "prefetch.copy")   # other threads' work under the interpreter

Interval = Tuple[int, int]


def _ns(base: int, us) -> int:
    return base + int(round(float(us) * 1000))


def device_ops(trace: Dict) -> List[Tuple[int, int, int, int, str]]:
    """(start_ns, end_ns, stream, correlation, name) of every operation on the device."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = _ns(base, e["ts"])
            args = e.get("args", {})
            out.append((a, a + int(round(float(e["dur"]) * 1000)), int(args.get("stream", -1)),
                        int(args.get("correlation", -1)), e.get("name", "")))
    return out


def launch_records(trace: Dict) -> Dict[int, Tuple[int, int]]:
    """correlation -> (ns, the trace's tid) of each launch record."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            out[int(e["args"]["correlation"])] = (_ns(base, e["ts"]), int(e.get("tid", -1)))
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[Interval] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        elif b > a:
            merged.append((a, b))
    return merged


def intersect(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """x less y, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(y) and y[k][0] < b:
            if y[k][0] > cur:
                out.append((cur, y[k][0]))
            cur = max(cur, y[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def length(x: Iterable[Interval]) -> int:
    return sum(b - a for a, b in x)


def _inside(x: Sequence[Interval], starts: Sequence[int], t: int) -> int:
    """The index of the interval of ``x`` (sorted, disjoint; ``starts`` their
    starts) that holds ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t < x[i][1] else -1


def summarize(trace: Dict, spans: Sequence, counters: Sequence, t0: int, t1: int,
              main_thread: int) -> Dict:
    """The window [t0, t1] (ns) of ``trace`` joined with the program's ``spans`` and
    ``counters`` (``tracing.py``'s ``Span`` and ``Counter``, or any object
    with their fields) recorded with ``main_thread`` the trainer's thread."""
    main = [s for s in spans if s.thread == main_thread and s.name in MAIN]
    step_spans = sorted((s.start, s.end, s.iteration) for s in main if s.name == "step")
    steps = [(a, b) for a, b, _ in step_spans]
    kids = sorted((s.start, s.end, s.name) for s in main if s.name != "step")   # back to back
    copies = union((s.start, s.end) for s in spans if s.name == "prefetch.copy")
    starts = {"step": [a for a, _ in steps], "kids": [a for a, _, _ in kids],
              "copies": [a for a, _ in copies]}
    records = launch_records(trace)
    ops = [op for op in device_ops(trace) if t0 <= op[0] < t1]

    def on_main(t: int) -> str:
        i = _inside(kids, starts["kids"], t)
        if i >= 0:
            return kids[i][2]
        return "step" if _inside(steps, starts["step"], t) >= 0 else "other"

    launch = [records.get(op[3], (None, None))[0] for op in ops]
    by_stream: Dict[int, float] = {}
    for (a, b, stream, _, _), t in zip(ops, launch):
        if t is not None and on_main(t) in STAGES:
            by_stream[stream] = by_stream.get(stream, 0.0) + (b - a)
    compute = max(by_stream, key=by_stream.get) if by_stream else None
    device_s: Dict[str, float] = {}
    other_streams_s: Dict[str, float] = {}
    for (a, b, stream, _, _), t in zip(ops, launch):
        if t is None:
            name = "unlaunched"
        elif stream == compute:
            name = on_main(t)
        else:
            name = "prefetch.copy" if _inside(copies, starts["copies"], t) >= 0 else "other"
        into = device_s if stream == compute else other_streams_s
        into[name] = into.get(name, 0.0) + (b - a) / 1e9
    compute_ops = [(a, b) for a, b, stream, _, _ in ops if stream == compute]
    launched = [t for (_, _, stream, _, _), t in zip(ops, launch)
                if stream == compute and t is not None]
    in_step = sum(_inside(steps, starts["step"], t) >= 0 for t in launched)
    step_iters = {it for a, _, it in step_spans if t0 <= a < t1}
    # the steps whose NMS scans were counted, and the compute stream's operations
    # they launched
    counted = {c.iteration for c in counters if c.name == "k3.ious" and c.iteration in step_iters}
    counted_kernels: Dict[str, List[float]] = {}
    for (a, b, stream, _, name), t in zip(ops, launch):
        i = -1 if t is None or stream != compute else _inside(steps, starts["step"], t)
        if i >= 0 and step_spans[i][2] in counted:
            k = counted_kernels.setdefault(name, [0.0, 0])
            k[0] += (b - a) / 1e9
            k[1] += 1

    window = [(t0, t1)]
    busy = union((max(a, t0), min(b, t1)) for a, b, _, _, _ in device_ops(trace)
                 if b > t0 and a < t1)
    idle = subtract(window, busy)
    data = union((s.start, s.end) for s in main if s.name == "data")
    enqueue = subtract(intersect(idle, steps), data)
    idle_data = intersect(idle, data)
    host = union((s.start, s.end) for s in spans
                 if s.thread != main_thread and s.name in HOST_WORK)
    by_span: Dict[str, float] = {}   # idle time by the main-thread span open
    idle_starts = [a for a, _ in idle]
    for a, b, name in [*kids, *[(a, b, "step") for a, b in subtract(steps, union(
            (a, b) for a, b, _ in kids))]]:
        i = max(0, bisect.bisect_right(idle_starts, a) - 1)
        while i < len(idle) and idle[i][0] < b:
            by_span[name] = by_span.get(name, 0.0) + max(
                0, min(b, idle[i][1]) - max(a, idle[i][0])) / 1e9
            i += 1
    maps = [s for s in spans if s.name == "loader.map" and t0 <= s.start and s.end <= t1]
    return {
        "window_s": (t1 - t0) / 1e9,
        "iterations": len(step_iters),
        "compute_stream": compute,
        "device_s": device_s,                  # compute stream, by main-thread span
        "other_streams_s": other_streams_s,
        "compute_busy_s": length(union(compute_ops)) / 1e9,
        "launches": len(launched),
        "launches_in_step": in_step,
        "idle_s": length(idle) / 1e9,
        "idle_enqueue_s": length(enqueue) / 1e9,
        "idle_data_s": length(idle_data) / 1e9,
        "idle_other_s": (length(idle) - length(enqueue) - length(idle_data)) / 1e9,
        "idle_enqueue_host_s": length(intersect(enqueue, host)) / 1e9,
        "idle_by_span_s": by_span,
        "enqueue_s": length(intersect(subtract(steps, data), window)) / 1e9,
        "enqueue_host_s": length(intersect(intersect(subtract(steps, data), window),
                                           host)) / 1e9,
        "map_s": {tag: sum(s.end - s.start for s in maps if s.tag == tag) / 1e9
                  for tag in sorted({s.tag for s in maps})},
        "map_n": {tag: sum(s.tag == tag for s in maps) for tag in sorted({s.tag for s in maps})},
        "ious": sum(c.value for c in counters if c.name == "k3.ious" and c.iteration in counted),
        "counted_kernels": counted_kernels,    # {name: [seconds, launches]}
        "counted_k3_launches": sum(c.value for c in counters
                                   if c.name == "k3.launches" and c.iteration in counted),
    }


def stage_ms(ctx: Dict, names: Sequence[str]) -> Optional[float]:
    """The compute stream's device ms per iteration in the stages ``names``, from
    ``ctx["stages"]`` (:func:`summarize`), or None where no such stage ran."""
    st = ctx.get("stages")
    if not st or not st["iterations"] or not any(k in st["device_s"] for k in names):
        return None
    return sum(st["device_s"].get(k, 0.0) for k in names) / st["iterations"] * 1e3
