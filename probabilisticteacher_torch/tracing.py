"""Spans and counters of the training iteration, on the wall clock of the device trace.

A :class:`Tracer` records, in memory, what the host threads of a training run do:

- on the main thread, one ``step`` span per ``PTrainer.run_step``, the parent of a
  ``data`` span around ``next(batch_iter)`` and of one span per stage of
  ``engine/steps.py``, each from the previous stage's end (or the end of ``data``)
  to its own mark: ``ema``, ``pseudo_labels``, ``augment``, ``forward``,
  ``backward``, ``grad_all_reduce`` (over several ranks) and ``optimizer``. What
  ``run_step`` does after the last mark is the self time of ``step``;
- on the loader's threads (``data/loader.py``), ``loader.map`` around each image's
  ``Mapper`` call, tagged ``l`` or ``u`` by its stream, and ``loader.batch``
  around the making of each batch (drawing, bucketing, stacking);
- on the prefetcher's thread (``parallel/prefetch.py``), ``prefetch.wait`` around
  its wait for the loader and ``prefetch.copy`` around the pinned copy it queues
  on the side stream.

Counters, each with the iteration it belongs to: ``prefetch.depth``, the batches
ready when the step asked for one (0: the step waited); at the end of each step
(``engine/trainer.py``), ``k1.launches``, ``k2.launches``, ``k3.launches`` and
``aug.launches`` (the step's launches of the CUDA kernels, the augmentation's three
together), and at the end of the tracer's first step
``k3.ious``, the IoUs its greedy NMS scans needed (``ops/nms.py``). A counter's
value may be a function, work put off until :meth:`drain` calls it: the IoUs are
counted by a slower instantiation of the kernel, after the work being timed.

A span has a name, a start and an end in ``time.time_ns()`` (the clock of the
profiler trace's ``baseTimeNanoseconds``), its thread's native id (the ``tid`` of
the trace's host events), the iteration the main thread was running when it began,
its parent on the same thread (``-1`` for none) and a tag. Nothing is written while
the tracer records; :meth:`drain` hands everything out. Off is no tracer at all:
the trainer, the loader and the prefetcher hold ``tracer = None`` and record
nothing, and the steps get their no-op mark. This module imports nothing of the
package: every layer may record into it.

With ``cuda_events=True`` each stage end also records a CUDA event, and
:meth:`stage_ms` gives the device time between consecutive marks.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Union

import torch


class Span(NamedTuple):
    id: int
    name: str
    start: int          # time.time_ns()
    end: int
    thread: int         # threading.get_native_id()
    iteration: int
    parent: int         # id of the enclosing span on the same thread, -1 for none
    tag: str = ""


class Counter(NamedTuple):
    name: str
    iteration: int
    value: Union[int, Callable[[], int]]   # an int once drained
    time: int           # time.time_ns() when recorded


class Trace(NamedTuple):
    spans: List[Span]
    counters: List[Counter]


def span(tracer: Optional["Tracer"], name: str, tag: str = ""):
    """``tracer.span(name, tag)``, or a context that records nothing when
    ``tracer`` is None."""
    return contextlib.nullcontext() if tracer is None else tracer.span(name, tag)


class Tracer:
    def __init__(self, cuda_events: bool = False):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._counters: List[Counter] = []
        self._ids = itertools.count()
        self._local = threading.local()   # each thread's stack of open span ids
        self.iteration = -1               # the main thread's step in flight
        self.steps = 0                    # the steps recorded so far
        self._cursor = 0                  # the end of the last stage, or of data
        self._step_id = -1
        self._events: Optional[List] = [] if cuda_events else None

    # ------------------------------------------------------------- any thread
    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def record(self, name: str, start: int, end: int, tag: str = "",
               parent: Optional[int] = None, span_id: Optional[int] = None,
               iteration: Optional[int] = None) -> None:
        """A finished span of the calling thread (its parent the thread's open span,
        its iteration the main thread's, unless given)."""
        stack = self._stack()
        s = Span(next(self._ids) if span_id is None else span_id, name, start, end,
                 threading.get_native_id(), self.iteration if iteration is None else iteration,
                 (stack[-1] if stack else -1) if parent is None else parent, tag)
        with self._lock:
            self._spans.append(s)

    @contextlib.contextmanager
    def span(self, name: str, tag: str = "") -> Iterator[None]:
        """A span around the block, the parent of the spans the thread opens in it."""
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else -1
        stack.append(sid)
        iteration = self.iteration
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            stack.pop()
            self.record(name, start, end, tag, parent, sid, iteration)

    def count(self, name: str, value: Union[int, Callable[[], int]]) -> None:
        """A counter of the main thread's iteration: an int, or a function that
        :meth:`drain` calls for it."""
        with self._lock:
            self._counters.append(Counter(name, self.iteration, value, time.time_ns()))

    # ------------------------------------------------------------ main thread
    @contextlib.contextmanager
    def step(self, iteration: int) -> Iterator[None]:
        """The ``step`` span of ``iteration``, the parent of ``data`` and the stages."""
        self.iteration = iteration
        self.steps += 1
        stack = self._stack()
        self._step_id = sid = next(self._ids)
        stack.append(sid)
        self._cursor = start = time.time_ns()
        if self._events is not None:
            self._event("start")
        try:
            yield
        finally:
            end = time.time_ns()
            stack.pop()
            self.record("step", start, end, parent=-1, span_id=sid, iteration=iteration)

    def data_done(self, seconds: float) -> None:
        """The ``data`` span: from the step's start, ``seconds`` long (the trainer's
        ``last_data_time``); the first stage starts at its end."""
        start = self._cursor
        self._cursor += int(round(seconds * 1e9))
        self.record("data", start, self._cursor, parent=self._step_id)
        if self._events is not None:
            self._event("data")

    def mark(self, stage: str) -> None:
        """The steps' ``mark``: the stage that ends now."""
        now = time.time_ns()
        self.record(stage, self._cursor, now, parent=self._step_id)
        self._cursor = now
        if self._events is not None:
            self._event(stage)

    def _event(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events.append((name, ev))

    def stage_ms(self) -> Dict[str, float]:
        """Device ms between each stage's mark and the one before it (the step's
        start, or the end of ``data``), summed by stage over the steps recorded
        since the last call; synchronizes with the card."""
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        events, self._events = self._events, []
        for (_, prev), (name, ev) in zip(events, events[1:]):
            if name not in ("start", "data"):
                out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
        return out

    # ------------------------------------------------------------- the end
    def drain(self) -> Trace:
        """Every span and counter recorded so far, each counter an int (a function's
        called now), and the tracer emptied."""
        with self._lock:
            spans, self._spans = self._spans, []
            counters, self._counters = self._counters, []
        return Trace(spans, [c._replace(value=int(c.value() if callable(c.value) else c.value))
                             for c in counters])


def chrome_events(trace: Trace, base_ns: int, pid: int) -> List[Dict]:
    """The spans as complete ("X") events and the counters as counter ("C")
    events of a Chrome trace whose ``ts`` count microseconds after ``base_ns``,
    on each span's own thread of process ``pid``."""
    out: List[Dict] = []
    for s in trace.spans:
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.start - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3,
                    "args": {"iteration": s.iteration, "id": s.id, "parent": s.parent,
                             "tag": s.tag}})
    for c in trace.counters:
        out.append({"ph": "C", "cat": "program_counter", "name": c.name, "pid": pid,
                    "ts": (c.time - base_ns) / 1e3,
                    "args": {"value": c.value, "iteration": c.iteration}})
    return out
