"""The port's tracer (``tracing.py``) on the CPU, burn-in and mutual steps.

- ``run_step``'s spans: one ``step`` per iteration, its ``data`` span as long as
  ``last_data_time``, then the stages in order, nested in the step, back to back,
  on ``time.time_ns()``; the step's counters, the IoUs of the tracer's first step
  counted by ``drain``;
- with no tracer: no span, no counter, no CUDA event, no synchronize, the steps'
  default mark, the NMS with no IoU counter;
- the tracer a leaf module, which every layer may import;
- the step's losses, gradients and weights bit-identical with the tracer on and off;
- the loader's ``loader.map`` spans one per image mapped, by stream, and the
  prefetcher's ``prefetch.*`` spans and depth counter one per batch;
- ``greedy_keep``'s IoU count against a row-by-row count of the greedy scan on
  planted cases (no overlap, chains, ties, invalid rows, ``max_keep`` cut-offs);
- ``ProfilerHook``'s trace with the spans, and one ``it/s`` on the console line.
"""

import ast
import copy
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import nms_tile_cases
from probabilisticteacher_torch.config import get_cfg
from probabilisticteacher_torch.data.datasets import register_pascal_voc
from probabilisticteacher_torch import tracing
from probabilisticteacher_torch.engine import steps as steps_mod
from probabilisticteacher_torch.engine.trainer import PTrainer
from probabilisticteacher_torch.events import ConsoleWriter, EventStorage
from probabilisticteacher_torch.ops import nms as tnms
from probabilisticteacher_torch.ops import nms_cuda
from probabilisticteacher_torch.ops.boxes import pairwise_iou
from probabilisticteacher_torch.parallel import DevicePrefetcher
from probabilisticteacher_torch.tracing import Tracer, chrome_events
from synthetic_data import CLASSES
from torch_micro import micro_opts, voc_tree

STAGES = {"burnin": ["data", "augment", "forward", "backward", "optimizer"],
          "mutual": ["data", "ema", "pseudo_labels", "augment", "forward", "backward",
                     "optimizer"]}
BURN_UP = 2


@pytest.fixture(scope="module")
def names(tmp_path_factory):
    root = voc_tree(str(tmp_path_factory.mktemp("voc")))
    for suffix, sub, split in (("l", "src", "train"), ("u", "tgt", "train"),
                               ("v", "val", "val")):
        register_pascal_voc(f"ttrace_{suffix}", os.path.join(root, sub), split, CLASSES)
    return "ttrace_l", "ttrace_u", "ttrace_v"


def _trainer(out, names, **kw):
    cfg = get_cfg()
    cfg.merge_from_list(micro_opts(out, *names, burn_up=BURN_UP, **kw))
    t = PTrainer(cfg)
    t.writers = []
    return t


def _first_iter(phase):
    return 0 if phase == "burnin" else BURN_UP


def _host_batches(trainer, n):
    it = iter(trainer.build_train_loader())
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _drive(trainer, batch_iter, phase, n):
    for i in range(n):
        trainer.iter = _first_iter(phase) + i
        trainer.run_step(batch_iter)


# -------------------------------------------------------------------- run_step
@pytest.mark.parametrize("phase", ["burnin", "mutual"])
def test_run_step_spans_nest_in_stage_order(tmp_path, names, phase):
    trainer = _trainer(tmp_path, names)
    batch_iter = trainer.make_batch_iterator(iter(trainer.build_train_loader()))
    tracer = trainer.tracer = Tracer()
    data_times = []
    before = time.time_ns()
    try:
        for i in range(2):
            trainer.iter = _first_iter(phase) + i
            trainer.run_step(batch_iter)
            data_times.append(trainer.last_data_time)
    finally:
        trainer.tracer = None
        batch_iter.close()
    after = time.time_ns()
    trace = tracer.drain()
    main = threading.get_native_id()
    steps = [s for s in trace.spans if s.name == "step"]
    assert [s.iteration for s in steps] == [_first_iter(phase), _first_iter(phase) + 1]
    for step, data_s in zip(steps, data_times):
        assert step.parent == -1 and step.thread == main
        assert before <= step.start < step.end <= after
        kids = sorted((s for s in trace.spans if s.parent == step.id), key=lambda s: s.start)
        assert [s.name for s in kids] == STAGES[phase]
        assert all(s.thread == main and s.iteration == step.iteration for s in kids)
        assert kids[0].start == step.start and kids[-1].end <= step.end
        for a, b in zip(kids, kids[1:]):
            assert a.end == b.start          # back to back: no overlap, no hole
        assert kids[0].end - kids[0].start == round(data_s * 1e9)
    counters = {}
    for c in trace.counters:
        counters.setdefault(c.name, []).append(c)
    for name in ("k1.launches", "k2.launches", "k3.launches", "aug.launches"):
        assert [c.iteration for c in counters[name]] == [s.iteration for s in steps]
    assert all(c.value == 0 for k in ("k1", "k2", "k3", "aug")
               for c in counters[f"{k}.launches"])
    # the first step's NMS scans (the RPN's, on the CPU), counted by drain
    assert [c.iteration for c in counters["k3.ious"]] == [steps[0].iteration]
    assert counters["k3.ious"][0].value > 0
    assert len(counters["prefetch.depth"]) == 2


def test_deferred_counters_are_counted_when_drained():
    """A counter may be a function, work put off past the window being timed:
    ``drain`` calls it, once, and every counter comes out an int."""
    tracer = Tracer()
    tracer.iteration = 3
    calls = []
    tracer.count("k3.ious", lambda: calls.append(1) or torch.tensor([41]))
    tracer.count("prefetch.depth", 2)
    assert calls == []
    trace = tracer.drain()
    assert calls == [1]
    assert [(c.name, c.iteration, c.value) for c in trace.counters] == [
        ("k3.ious", 3, 41), ("prefetch.depth", 3, 2)]
    assert all(type(c.value) is int for c in trace.counters)
    assert tracer.drain() == ([], [])


def test_the_tracer_imports_nothing_of_the_package():
    """The data and parallel layers record into the tracer: it must not depend on
    the engine, the kernels or the NMS."""
    with open(tracing.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    froms = [(n.level, n.module) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert all(level == 0 for level, _ in froms)
    assert not [m for m in names + [m for _, m in froms]
                if m and m.split(".")[0] == "probabilisticteacher_torch"]


@pytest.mark.parametrize("phase", ["burnin", "mutual"])
def test_no_tracer_records_nothing(tmp_path, names, phase, monkeypatch):
    trainer = _trainer(tmp_path, names)
    batch_iter = trainer.make_batch_iterator(iter(trainer.build_train_loader()))
    assert trainer.tracer is None and batch_iter.tracer is None
    assert all(p.tracer is None for p in trainer._traced_parts)
    seen = {"marks": [], "counts": []}

    def wrap(step):
        def run(*args, **kw):
            seen["marks"].append(len(args) + len(kw))
            return step(*args, **kw)
        return run

    def forbidden(*a, **k):
        raise AssertionError("recorded with no tracer")

    real_keep = nms_cuda.greedy_keep

    def keep(*args):
        seen["counts"].append((len(args), tnms.recorded_scans()))
        return real_keep(*args)

    trainer.burnin_step, trainer.mutual_step = wrap(trainer.burnin_step), wrap(
        trainer.mutual_step)
    monkeypatch.setattr(nms_cuda, "greedy_keep", keep)
    for name in ("record", "count", "mark", "data_done", "step", "span"):
        monkeypatch.setattr(Tracer, name, forbidden)
    monkeypatch.setattr(nms_cuda, "count_ious", forbidden)
    monkeypatch.setattr(nms_cuda, "counting_keep", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    try:
        _drive(trainer, batch_iter, phase, 2)
    finally:
        batch_iter.close()
    # the steps were called without a mark: they used their default, _no_mark
    assert seen["marks"] == [4 if phase == "burnin" else 5] * 2
    for step in (steps_mod.make_train_steps(trainer.cfg, trainer.state.student)):
        assert step.__defaults__[-1] is steps_mod._no_mark
    # the scans neither count (no counter argument) nor are kept for counting
    assert seen["counts"] and all(c == (5, None) for c in seen["counts"])


@pytest.mark.parametrize("phase", ["burnin", "mutual"])
def test_step_is_bit_identical_with_the_tracer_on_and_off(tmp_path, names, phase):
    runs = []
    batches = None
    for traced in (False, True):
        trainer = _trainer(tmp_path / str(traced), names)
        if batches is None:
            batches = _host_batches(trainer, 2)
        if traced:
            trainer.tracer = Tracer()
        _drive(trainer, iter(copy.deepcopy(batches)), phase, 2)
        state = trainer.state
        runs.append((trainer.pending_metrics.values(),
                     [p.detach().clone() for p in state.student.parameters()],
                     [p.grad.clone() for p in state.student.parameters() if p.grad is not None],
                     [p.detach().clone() for p in state.teacher.parameters()]))
        if traced:
            assert any(s.name == "forward" for s in trainer.tracer.drain().spans)
    (m0, w0, g0, t0), (m1, w1, g1, t1) = runs
    assert m0 == m1
    assert len(g0) == len(g1) > 0
    for a, b in zip(w0 + g0 + t0, w1 + g1 + t1):
        assert torch.equal(a, b)


# --------------------------------------------------------- loader, prefetcher
def test_loader_map_spans_one_per_image_by_stream(tmp_path, names):
    trainer = _trainer(tmp_path, names)
    loader = trainer.build_train_loader()
    mapped = {"l": 0, "u": 0}
    real = loader._map_one

    def map_one(item):
        mapped[item[2]] += 1
        return real(item)

    loader._map_one = map_one
    tracer = trainer.tracer = Tracer()
    assert loader.tracer is tracer
    for _ in range(3):
        loader._produce_one()
    trainer.tracer = None
    assert loader.tracer is None
    spans = tracer.drain().spans
    maps = [s for s in spans if s.name == "loader.map"]
    assert {t: sum(s.tag == t for s in maps) for t in "lu"} == mapped
    assert mapped["l"] >= 6 and mapped["u"] >= 6
    assert all(s.end >= s.start for s in maps)
    # the loader's own thread: one loader.batch span around each batch it makes
    loader.tracer = tracer
    it = iter(loader)
    got = [next(it) for _ in range(2)]
    it.close()
    batches = [s for s in tracer.drain().spans if s.name == "loader.batch"]
    assert len(got) == 2 and len(batches) >= 2
    assert all(s.thread != threading.get_native_id() for s in batches)


def test_prefetch_spans_and_depth_one_per_batch():
    start, release = threading.Event(), threading.Event()
    n = 4

    def host():
        start.wait(30)        # the worker read its tracer (None) before it waits here
        yield from range(n + 1)
        release.wait(30)      # and waits here inside an open prefetch.wait
        yield from range(100)

    p = DevicePrefetcher(host(), lambda b, it: {"b": b, "it": it}, start_iter=7, depth=2)
    tracer = p.tracer = Tracer()
    start.set()
    try:
        # each copy's span ends before its batch is queued: batches 1-4 are traced
        got = [next(p) for _ in range(n)]
        deadline = time.time() + 30
        while p._q.qsize() < 1 and time.time() < deadline:   # batch 4 copied too
            time.sleep(0.01)
        trace = tracer.drain()
    finally:
        release.set()
        p.close()
    assert [g["b"] for g in got] == list(range(n))
    waits = [s for s in trace.spans if s.name == "prefetch.wait"]
    copies = [s for s in trace.spans if s.name == "prefetch.copy"]
    depth = [c for c in trace.counters if c.name == "prefetch.depth"]
    assert len(depth) == n and all(0 <= c.value <= 2 for c in depth)
    assert len(copies) == len(waits) == n
    assert all(w.end <= c.start for w, c in zip(waits, copies))
    assert len({s.thread for s in waits + copies}) == 1
    assert waits[0].thread != threading.get_native_id()


# ------------------------------------------------------------- K3's IoU count
def _scan_count(iou, valid, thresh, max_keep):
    """Row by row: each valid row is tested against the kept rows in order until
    one suppresses it; the scan stops at its max_keep-th kept row."""
    kept, n = [], 0
    for i in range(iou.shape[0]):
        if not valid[i]:
            continue
        for q in kept:
            n += 1
            if iou[q, i] > thresh:
                break
        else:
            kept.append(i)
            if len(kept) == max_keep:
                break
    return n


def _grid(k):
    xs, ys = np.meshgrid(np.arange(20) * 100.0, np.arange(20) * 100.0)
    return np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 50, ys.ravel() + 50], 1)[:k]


def _planted(name):
    if name.startswith("no_overlap"):
        k, max_keep = 300, (300 if name == "no_overlap" else 37)
        boxes = _grid(k)[None].astype(np.float32)
        scores = np.linspace(1.0, 0.1, k, dtype=np.float32)[None]
        valid = np.ones((1, k), bool)
        valid[0, 5::9] = False
        return boxes, scores, valid, max_keep, 0.5
    if name.startswith("cut_"):                  # a tile case with max_keep cut short
        base, max_keep = name[4:].rsplit("_", 1)
        boxes, scores, valid, _, thresh = nms_tile_cases.make(base, n=2)
        return boxes, scores, valid, int(max_keep), thresh
    return nms_tile_cases.make(name, n=2)


PLANTED = ["no_overlap", "no_overlap_cut", *nms_tile_cases.CPU_CASES, "cut_chain_7",
           "cut_ties_30", "cut_invalid_tile_60", "cut_k257_1"]


@pytest.mark.parametrize("case", PLANTED)
def test_greedy_keep_counts_the_ious_the_scan_needs(case):
    boxes, scores, valid, max_keep, thresh = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in _planted(case))
    _, b_s, a_s, v_s = tnms.sort_by_score(boxes, scores, valid)
    count = torch.zeros(1, dtype=torch.int64)
    keep = tnms.greedy_keep(b_s, a_s, v_s, thresh, max_keep, count)
    assert torch.equal(keep, tnms.greedy_keep(b_s, a_s, v_s, thresh, max_keep))
    want = sum(_scan_count(pairwise_iou(b_s[i], b_s[i]).numpy(), v_s[i].numpy(), thresh,
                           max_keep) for i in range(b_s.shape[0]))
    assert int(count) == want
    if case.startswith("no_overlap"):   # nothing suppresses: each kept row tests those ahead
        assert want == sum(range(int(keep.sum())))
    # the program's path: the scans kept while recording, counted afterwards
    scans = []
    with tnms.recording_scans(scans):
        nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep)
        nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep)
    assert len(scans) == 2 and tnms.recorded_scans() is None
    assert nms_cuda.count_ious(scans) == 2 * want


# ----------------------------------------------------------- the operator's view
def test_profiler_hook_puts_the_spans_in_its_trace(tmp_path, names):
    trainer = _trainer(tmp_path, names, max_iter=3)
    trainer.cfg.defrost()
    trainer.cfg.TEST.EVAL_PERIOD = 0
    trainer.cfg.SOLVER.CHECKPOINT_PERIOD = 0
    trainer.cfg.PROFILER.ENABLED = True
    trainer.cfg.PROFILER.START_STEP = 1
    trainer.cfg.PROFILER.NUM_STEPS = 2
    trainer._hooks = []
    trainer.register_hooks(trainer.build_hooks())
    trainer.test = lambda model, max_images=0: {}
    trainer.train()
    assert trainer.tracer is None
    with open(os.path.join(tmp_path, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    steps = [e for e in spans if e["name"] == "step"]
    assert sorted(e["args"]["iteration"] for e in steps) == [1, 2]
    assert {"data", "augment", "ema", "pseudo_labels", "forward", "backward",
            "optimizer", "loader.map", "prefetch.copy"} <= {e["name"] for e in spans}
    assert all(e["dur"] >= 0 for e in spans)
    assert {e["name"] for e in events if e.get("cat") == "program_counter"} >= {
        "k3.ious", "prefetch.depth"}


def test_threads_lose_no_span():
    """Many threads record at once, switching often: every span arrives once, with
    its own id, parented on its own thread."""
    tracer = Tracer()
    n_threads, n_spans = 16, 400
    old = sys.getswitchinterval()

    def work():
        for i in range(n_spans):
            with tracer.span("outer", "x"):
                with tracer.span("inner"):
                    [object() for _ in range(8)]
            if i % 100 == 0:
                tracer.count("c", i)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    trace = tracer.drain()
    spans = trace.spans
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s.id for s in trace.spans}) == len(trace.spans)
    by_id = {s.id: s for s in spans}
    inner = [s for s in spans if s.name == "inner"]
    assert all(by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread
               and by_id[s.parent].start <= s.start <= s.end <= by_id[s.parent].end
               for s in inner)
    assert len([c for c in trace.counters if c.name == "c"]) == n_threads * n_spans // 100


def test_chrome_events_are_on_the_trace_clock():
    tr = tracing.Trace([tracing.Span(3, "forward", 5_000_000, 7_500_000, 11, 4, 1)],
                       [tracing.Counter("k3.ious", 4, 99, 6_000_000)])
    span, counter = chrome_events(tr, 1_000_000, 42)
    assert (span["ts"], span["dur"], span["tid"], span["pid"]) == (4000.0, 2500.0, 11, 42)
    assert span["args"] == {"iteration": 4, "id": 3, "parent": 1, "tag": ""}
    assert counter["ph"] == "C" and counter["ts"] == 5000.0 and counter["args"]["value"] == 99


def test_console_line_has_one_rate(caplog):
    s = EventStorage()
    s.iter = 20
    s.put_scalars(**{"total_loss": 1.0, "it/s": 2.5, "data_time": 0.1})
    with caplog.at_level(logging.INFO, logger="probabilisticteacher_torch"):
        ConsoleWriter(max_iter=100).write(s)
    line = caplog.records[-1].getMessage()
    assert line.count("it/s") == 1 and "it/s: 2.5" in line
