"""Reading a profiler trace: device busy time, kernel times by name, and the device's
idle gaps named by the benchmark's own host span open when each began.

The trace is the JSON that ``torch.profiler`` exports (``export_chrome_trace``).
Its events carry ``ts`` in microseconds after ``baseTimeNanoseconds``, on the wall
clock that ``time.time_ns()`` reads; the host spans are stamped with that clock,
so both lie on one time line.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160      # device op names are cut to this length in the breakdown
TOP = 10


def device_events(trace: Dict) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation that ran on the device."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            start = base + int(round(float(e["ts"]) * 1000))
            out.append((str(e.get("name", "?")), start, start + int(round(float(e["dur"]) * 1000))))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _span_at(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The innermost (shortest) host span open at ``t``, or "other"."""
    best, best_len = "other", None
    for name, a, b in spans:
        if a <= t < b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def summarize(events: Sequence[Tuple[str, int, int]], t0: int, t1: int,
              spans: Sequence[Tuple[str, int, int]] = ()) -> Dict:
    """Device time over the window [t0, t1] (ns): ``busy_s`` (the union of the
    device operations' intervals), ``window_s``, ``kernels`` {name: [seconds,
    launches]} of the operations that began in the window, and the breakdown: the
    ``device_ops`` that took the most time and the longest ``idle_gaps``, each gap
    named by the host span open when it began."""
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in events if b > t0 and a < t1]
    busy = _union((a, b) for _, a, b in inside)
    kernels: Dict[str, List[float]] = {}
    for n, a, b in events:
        if t0 <= a < t1:
            k = kernels.setdefault(n, [0.0, 0])
            k[0] += (b - a) / 1e9
            k[1] += 1
    gaps, cursor = [], t0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        gaps.append((cursor, t1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    ops = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:TOP]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in ops],
        "idle_gaps": [[_span_at(spans, a), (b - a) / 1e9] for a, b in gaps[:TOP]],
    }


def kernel_time(kernels: Dict[str, List[float]], pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds ``pattern``."""
    s, n = 0.0, 0
    for name, (sec, count) in kernels.items():
        if pattern in name:
            s += sec
            n += count
    return s, n
