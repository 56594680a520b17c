"""One run of one cell: set-up, three compared iterations, the measured window, the
plain reference, and the result line.

The window drives ``PTrainer.run_step`` as the training CLI does: the trainer's own
device prefetcher (``make_batch_iterator``) over the port's ``SemiSupLoader``, which
reads the cell's JPEG tree from disk and decodes it on its threads. The loop is
closed: the next iteration is issued when ``run_step`` returns, and each step's
metrics are read one step late. The eval and checkpoint hooks do not run.

Set-up builds one trainer, loads the benchmark's weights into its student, and
drives it from the seed through three iterations whose batches, teacher detections,
metrics, first-step RPN head outputs, first gradient, and the student's and the EMA
teacher's parameter change it keeps; a fourth warms the rest, and
the same trainer and feed go on into the window. After the window, with the peak
memory read and the program's state freed, the reference repeats those three
iterations from the files, the weights and the draws, and ``check.compare`` decides
``correct``.

A traced run also gives the trainer a tracer (``probabilisticteacher_torch/tracing.py``)
for the window alone: its spans and counters are joined to the profiler's trace
(``harness/stages.py``) for the per-layer readers, and name the device's idle gaps.
An untraced run makes no tracer. The reference and the work counts are the ones the
configuration names (``reference_of``, ``counts_of``).
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, counts, stages, trace as trace_mod, tree as tree_mod
from .cells import Cell, bench_module, metric_reader
from .weights import make_weights

BANNED_MODULES = ("jax", "jaxlib", "flax", "probabilisticteacher_tpu")
COMPARED_STEPS = 3
EXTRA_WARM_STEPS = 1
# what a configuration's reference module gives ``run_reference``: the sizes
# (``Arch.from_dict`` of the file's ``arch``), the detector ``Detector(arch, device,
# prec)`` with its ``rpn_head``, the precisions ``exact`` and ``fp8_e4m3`` (the
# control), the batch types, and the steps
REFERENCE_NAMES = ("Arch", "Detector", "ImageBatch", "GroundTruth", "exact", "fp8_e4m3",
                   "build_state", "burnin_step", "mutual_step")


def process_start_ns() -> int:
    """Wall-clock start of this process, from /proc (0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return int((btime + start_ticks / os.sysconf("SC_CLK_TCK")) * 1e9)
    except (OSError, ValueError, IndexError, StopIteration):
        return 0


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` equal, whole, to JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED_MODULES))


def step_seed(seed: int, it: int) -> int:
    """The seed of iteration ``it``'s draws, given to the program and the reference."""
    return (seed * 6364136223846793005 + it * 1442695040888963407 + 1) % (2 ** 63)


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


# --------------------------------------------------------------------------- the cell
def reference_of(cell: Cell):
    """The configuration's reference: the module its file names under ``"reference"``
    (``benchmark/reference/<name>.py``), by default ``reference/vgg16.py``; it has to
    give ``REFERENCE_NAMES``."""
    name = cell.config.get("reference", "vgg16")
    mod = bench_module(cell.bench_dir, "reference", name)
    missing = [n for n in REFERENCE_NAMES if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"reference module {name!r} lacks {missing}")
    return mod


def counts_of(cell: Cell):
    """The configuration's work counts: the module its file names under ``"counts"``
    (``benchmark/harness/<name>.py``), or ``harness/counts.py``'s VGG16 counts; each
    gives ``iteration_flops`` and ``kernel_launches``."""
    return bench_module(cell.bench_dir, "harness", cell.config.get("counts", "counts"))


def start_iter(cell: Cell) -> int:
    s = cell.traffic["start_iter"]
    return int(cell.config["train"]["burn_up_step"]) if s == "burn_up" else int(s)


def trees(cell: Cell, workers: int) -> Dict[str, str]:
    """The label and unlabel trees of the cell, written first where missing."""
    cfg, tr = cell.config, cell.traffic
    inp = cfg["input"]
    out = {}
    for stream, count_key in (("label", "label_images"), ("unlabel", "unlabel_images")):
        spec = tree_mod.tree_spec(cfg["datasets"][stream], cfg[count_key], tr["stored_scale"],
                                  tr["tree_seed"] + (0 if stream == "label" else 1),
                                  inp["min_size_train"][0], inp["max_size_train"],
                                  tr["jpeg_quality"])
        out[stream] = tree_mod.ensure_tree(os.path.join(cell.bench_dir, ".cache"), spec, workers)
    return out


def program_cfg(cell: Cell, repo: str, seed: int, out_dir: str, device: str):
    """The program's config: the recipe, the cell's overrides, and the run's seed,
    output directory, device and datasets."""
    from probabilisticteacher_torch.config import get_cfg

    c = cell.config
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(repo, c["recipe"]))
    cfg.merge_from_list(list(c["overrides"]))
    cfg.defrost()
    cfg.SEED = int(seed)
    cfg.OUTPUT_DIR = out_dir
    cfg.MODEL.DEVICE = device
    cfg.DATASETS.TRAIN_LABEL = ("benchmark_label",)
    cfg.DATASETS.TRAIN_UNLABEL = ("benchmark_unlabel",)
    return cfg


def config_mismatches(cell: Cell, cfg) -> List[str]:
    """Where the program's config differs from the configuration file that the
    reference reads: each such key, with both values."""
    import dataclasses

    from probabilisticteacher_torch.config import Arch

    c = cell.config
    arch = dataclasses.asdict(Arch.from_cfg(cfg))
    got = {}
    for k in c["arch"]:
        got["arch." + k] = arch.get(k)
    s = cfg.SOLVER
    got.update({"solver.base_lr": s.BASE_LR, "solver.gamma": s.GAMMA,
                "solver.steps": s.STEPS, "solver.warmup_method": s.WARMUP_METHOD,
                "solver.warmup_iters": s.WARMUP_ITERS, "solver.warmup_factor": s.WARMUP_FACTOR,
                "solver.momentum": s.MOMENTUM, "solver.weight_decay": s.WEIGHT_DECAY,
                "solver.clip_enabled": s.CLIP_GRADIENTS.ENABLED,
                "solver.clip_value": s.CLIP_GRADIENTS.CLIP_VALUE,
                "solver.nesterov": s.NESTEROV, "precision": arch["compute_dtype"]})
    u = cfg.UNSUPNET
    got.update({"train.img_per_batch_label": s.IMG_PER_BATCH_LABEL,
                "train.img_per_batch_unlabel": s.IMG_PER_BATCH_UNLABEL,
                "train.burn_up_step": u.BURN_UP_STEP, "train.ema_keep_rate": u.EMA_KEEP_RATE,
                "train.teacher_update_iter": u.TEACHER_UPDATE_ITER,
                "train.source_loss_weight": u.SOURCE_LOSS_WEIGHT,
                "train.target_unsup_loss_weight": u.TARGET_UNSUP_LOSS_WEIGHT,
                "train.unsup_loss_warmup_iters": u.UNSUP_LOSS_WARMUP_ITERS})
    i, d = cfg.INPUT, cfg.DATALOADER
    got.update({"input.min_size_train": i.MIN_SIZE_TRAIN, "input.max_size_train": i.MAX_SIZE_TRAIN,
                "input.canvas_wide": i.CANVAS.WIDE, "input.canvas_tall": i.CANVAS.TALL,
                "input.max_gt": i.MAX_GT, "input.random_flip": i.RANDOM_FLIP,
                "input.format": i.FORMAT, "input.min_size_train_sampling":
                i.MIN_SIZE_TRAIN_SAMPLING, "input.crop": i.CROP.ENABLED,
                "input.num_workers": d.NUM_WORKERS, "input.device_prefetch": d.DEVICE_PREFETCH,
                "input.filter_empty": d.FILTER_EMPTY_ANNOTATIONS})
    want = {}
    for group in ("arch", "solver", "train", "input"):
        for k, v in c[group].items():
            want[f"{group}.{k}"] = v
    want["precision"] = c["precision"]

    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, float):
            return float(np.float32(v))
        return v

    return [f"{k}: file {want[k]!r}, program {got.get(k)!r}" for k in want
            if norm(want[k]) != norm(got.get(k))]


# ------------------------------------------------------------------------ the feed
class Feed:
    """The trainer's batch iterator, with the benchmark's span around each ``next``
    and, while ``keep`` is a list, the batches it hands out."""

    def __init__(self, it, spans: List):
        self.it = it
        self.spans = spans
        self.keep: Optional[List] = None

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.time_ns()
        b = next(self.it)
        self.spans.append(("next(batch_iter)", t0, time.time_ns()))
        if self.keep is not None:
            self.keep.append(b)
        return b

    def close(self):
        if hasattr(self.it, "close"):
            self.it.close()


# --------------------------------------------------------------------- the program
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_program(cell: Cell, repo: str, seed: int, seconds: float, traced: bool, device: str,
                t_start_ns: int) -> Dict:
    """Set-up, compared iterations and the window on the program; returns the
    capture, the initial weights (host), the window's numbers and the trace."""
    from probabilisticteacher_torch.data.datasets import register_pascal_voc
    from probabilisticteacher_torch.engine.trainer import PTrainer

    dev = torch.device(device)
    c = cell.config
    tdirs = trees(cell, max(1, min(8, os.cpu_count() or 1)))
    for stream, name in (("label", "benchmark_label"), ("unlabel", "benchmark_unlabel")):
        register_pascal_voc(name, tdirs[stream], "train", c["datasets"][stream]["class_names"])
    out_dir = tempfile.mkdtemp(prefix="benchmark-trainer-")
    cfg = program_cfg(cell, repo, seed, out_dir, "cpu" if dev.type == "cpu" else "cuda")
    trainer = PTrainer(cfg)
    bad = config_mismatches(cell, trainer.cfg)
    if bad:
        raise RuntimeError("the configuration file does not describe what the program "
                           "runs:\n  " + "\n  ".join(bad))
    phase = cell.traffic["phase"]
    s0 = start_iter(cell)
    burn_up = int(c["train"]["burn_up_step"])
    if (phase == "mutual") != (s0 >= burn_up):
        raise ValueError(f"start iteration {s0} is not in the {phase} phase (BURN_UP_STEP "
                         f"{burn_up})")

    student = trainer.state.student
    shapes = {k: tuple(v.shape) for k, v in student.state_dict().items()}
    fixed = {}
    if "anchor_wh" in shapes:
        fixed["anchor_wh"] = torch.tensor(c["arch"]["anchor_init_wh"], dtype=torch.float32)
    weights = make_weights(shapes, seed, dev, fixed)
    student.load_state_dict(weights)
    p0 = {k: v.detach().cpu() for k, v in weights.items()}
    del weights
    trainer.start_iter = s0
    trainer.state.step = s0
    trainer.state.optimizer.count = s0
    gen = torch.Generator(device=dev)
    trainer.step_generator = lambda it: gen.manual_seed(step_seed(seed, it))

    spans: List = []
    feed = Feed(trainer.make_batch_iterator(iter(trainer.build_train_loader())), spans)
    cap = check.Capture()
    names = {id(p): n for n, p in student.named_parameters()}
    opt = trainer.state.optimizer
    wd = float(cfg.SOLVER.WEIGHT_DECAY)
    teacher = trainer.state.teacher
    real_roi_inference = teacher._roi_inference

    def capture_dets(*a, **k):
        det = real_roi_inference(*a, **k)
        cap.dets.append(check.host_dets(det))
        return det

    if phase == "mutual":
        teacher._roi_inference = capture_dets
    feed.keep = []
    it = s0
    for i in range(COMPARED_STEPS):
        trainer.iter = trainer.storage.iter = it
        hook = student.rpn_head.register_forward_hook(check.record_rpn(cap)) if i == 0 else None
        trainer.run_step(feed)
        _sync(dev)
        if hook is not None:
            hook.remove()
        cap.metrics.append(trainer.pending_metrics.values())
        b = feed.keep.pop()
        if "limg" not in b:
            raise RuntimeError("the trainer's feed gave a host batch, not a device batch")
        cap.batches.append(check.host_batch(b["limg"], b["lgt"], b.get("uimg")))
        del b
        if i == 0:
            for g in opt.param_groups:
                for p in g["params"]:
                    n = names[id(p)]
                    cap.grad1[n] = opt.state[p]["trace"].detach().cpu() - wd * p0[n]
        it += 1
    cap.delta3 = check.params_less(student, p0, cap.grad1)
    feed.keep = None
    if phase == "mutual":
        cap.teacher3 = check.params_less(teacher, p0, cap.grad1)
        del teacher._roi_inference
    for _ in range(EXTRA_WARM_STEPS):
        trainer.iter = trainer.storage.iter = it
        trainer.run_step(feed)
        it += 1
    _sync(dev)
    prev = trainer.pending_metrics
    setup_s = (time.time_ns() - t_start_ns) / 1e9
    n_img = int(c["train"]["img_per_batch_label"]) + int(c["train"]["img_per_batch_unlabel"])

    prof = tracer = None
    if traced:
        # the program's spans and counters, over the window only
        from probabilisticteacher_torch.tracing import Tracer
        tracer = trainer.tracer = Tracer()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        prof.__enter__()
    spans.clear()
    iters, data_wait, failed = 0, 0.0, 0
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    while True:
        trainer.iter = trainer.storage.iter = it
        a = time.time_ns()
        trainer.run_step(feed)
        spans.append(("run_step", a, time.time_ns()))
        data_wait += trainer.last_data_time
        a = time.time_ns()
        vals = prev.values()
        spans.append(("metrics fetch", a, time.time_ns()))
        failed += not math.isfinite(vals.get("total_loss", float("nan")))
        prev = trainer.pending_metrics
        iters += 1
        it += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    t1_ns = time.time_ns()
    if tracer is not None:
        trainer.tracer = None
    # the window's last step, read after it
    failed += not math.isfinite(prev.values().get("total_loss", float("nan")))
    summary = stage_summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
        os.remove(path)
        main = threading.get_native_id()
        program = tracer.drain()
        # each idle gap is named by the innermost span open when it began: the
        # program's stage where one was, else the benchmark's own
        spans += [(s.name, s.start, s.end) for s in program.spans if s.thread == main]
        summary = trace_mod.summarize(trace_mod.device_events(raw), t0_ns, t1_ns, spans)
        stage_summary = stages.summarize(raw, program.spans, program.counters, t0_ns, t1_ns,
                                         main)
        del raw, program
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if phase == "burnin" and it > burn_up:
        raise ValueError(f"the burn-in window reached iteration {it}, past BURN_UP_STEP")

    from probabilisticteacher_torch.data import native
    decoder = "native" if (cfg.DATALOADER.NATIVE and native.available()) else "PIL"
    feed.close()
    del trainer, student, teacher, opt, feed, prev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"capture": cap, "p0": p0, "trees": tdirs, "setup_s": setup_s,
            "window_s": window_s, "iterations": iters, "images": n_img * iters,
            "data_wait_s": data_wait, "failed": failed, "peak_bytes": peak, "trace": summary,
            "stages": stage_summary, "decoder": decoder, "start_iter": s0}


# ------------------------------------------------------------------- the reference
def run_reference(cell: Cell, p0: Dict[str, torch.Tensor], tdirs: Dict[str, str], seed: int,
                  device: str, s0: int, control: bool = False) -> check.Capture:
    """The reference's first three iterations (f32, TF32 off; ``control``: its
    convolution and matmul operands rounded to fp8 e4m3)."""
    rdata = bench_module(cell.bench_dir, "reference", "data")
    ref = reference_of(cell)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    c = cell.config
    arch = ref.Arch.from_dict(c["arch"])
    prec = ref.fp8_e4m3 if control else ref.exact
    model = ref.Detector(arch, dev, prec)
    model.load_state_dict({k: v.to(dev) for k, v in p0.items()})
    st = ref.build_state(model, c["solver"], arch.freeze_at, s0)
    names = {id(p): n for n, p in model.named_parameters()}
    inp, tr = c["input"], c["train"]
    mapper = rdata.Mapper(inp["min_size_train"], inp["max_size_train"], inp["canvas_wide"],
                          inp["canvas_tall"], inp["max_gt"], inp["random_flip"] != "none")
    ds = c["datasets"]
    feed = rdata.batches(rdata.load_voc(tdirs["label"], "train", ds["label"]["class_names"]),
                         rdata.load_voc(tdirs["unlabel"], "train", ds["unlabel"]["class_names"]),
                         mapper, seed, int(tr["img_per_batch_label"]),
                         int(tr["img_per_batch_unlabel"]), max(1, int(inp["num_workers"])))
    cap = check.Capture()
    gen = torch.Generator(device=dev)
    wd = float(c["solver"]["weight_decay"])
    phase = cell.traffic["phase"]
    burn_up = int(tr["burn_up_step"])
    for i in range(COMPARED_STEPS):
        hb = next(feed)
        lb, ub = hb["label"], hb["unlabel"]
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
        limg = ref.ImageBatch(t(lb["image"]), t(lb["image_hw"]))
        lgt = ref.GroundTruth(t(lb["gt_boxes"]), t(lb["gt_classes"].astype(np.int32)),
                              t(lb["gt_valid"]))
        g = gen.manual_seed(step_seed(seed, s0 + i))
        hook = model.rpn_head.register_forward_hook(check.record_rpn(cap)) if i == 0 else None
        if phase == "mutual":
            uimg = ref.ImageBatch(t(ub["image"]), t(ub["image_hw"]))
            cap.batches.append(check.host_batch(limg, lgt, uimg))
            m = ref.mutual_step(st, s0 + i, burn_up, tr, limg, lgt, uimg, g,
                                arch.pixel_mean, lambda d: cap.dets.append(check.host_dets(d)))
        else:
            cap.batches.append(check.host_batch(limg, lgt))
            m = ref.burnin_step(st, limg, lgt, g, arch.pixel_mean)
        if hook is not None:
            hook.remove()
        cap.metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            for p, tr_ in zip(st.optimizer.params, st.optimizer.trace):
                n = names[id(p)]
                cap.grad1[n] = tr_.detach().cpu() - wd * p0[n]
    cap.delta3 = check.params_less(model, p0, cap.grad1)
    if phase == "mutual":
        cap.teacher3 = check.params_less(st.teacher, p0, cap.grad1)
    del model, st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return cap


# ------------------------------------------------------------------------- the run
def per_layer(cell: Cell, res: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds something for."""
    c = cell.config
    tr = c["train"]
    phase = cell.traffic["phase"]
    n_l, n_u = int(tr["img_per_batch_label"]), int(tr["img_per_batch_unlabel"])
    short, max_size = c["input"]["min_size_train"][0], c["input"]["max_size_train"]
    hw_l = tree_mod.stored_hw(c["datasets"]["label"]["hw"], "train", short, max_size)
    hw_u = tree_mod.stored_hw(c["datasets"]["unlabel"]["hw"], "train", short, max_size)
    work = counts_of(cell)
    ctx = dict(res)
    ctx.update(phase=phase, config=c, traffic=cell.traffic,
               flops_per_iter=work.iteration_flops(c["arch"], phase, n_l, n_u, hw_l,
                                                   hw_u)["total"],
               peak_flops=counts.H100_BF16_FLOPS,
               launches=work.kernel_launches(c["arch"], phase, n_l, n_u,
                                             c["input"]["canvas_wide"]))
    out = {}
    for m in cell.per_layer:
        v = metric_reader(cell.bench_dir, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def end_to_end(res: Dict) -> Dict[str, float]:
    """The end-to-end metrics of a run: every image the window's iterations drew
    from the two streams over all of the window's seconds, the allocator's peak
    over set-up and window, and the set-up's seconds."""
    return {"train_img_s": res["images"] / res["window_s"],
            "peak_mem_gib": res["peak_bytes"] / 2 ** 30,
            "setup_s": res["setup_s"]}


def run_cell(cell: Cell, repo: str, seed: int, seconds: float, traced: bool, device: str,
             t_start_ns: int, log=print) -> Dict:
    """The whole run; returns the result line as a dict (keys in the contract's
    order, ``checks`` last)."""
    res = run_program(cell, repo, seed, seconds, traced, device, t_start_ns)
    log(f"decoder: {res['decoder']}; window {res['window_s']!r} s, {res['iterations']} "
        f"iterations; set-up {res['setup_s']!r} s")
    ref = run_reference(cell, res["p0"], res["trees"], seed, device, res["start_iter"])
    checks = check.judge(check.compare(res["capture"], ref, cell.limits), cell.limits)
    metrics = {}
    if traced:
        metrics = per_layer(cell, res)
    else:
        e2e = end_to_end(res)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(res["peak_bytes"])}
    line = {"correct": check.passed(checks) and res["failed"] == 0,
            "attempted": res["iterations"], "failed": res["failed"], "metrics": metrics,
            "device": device_info}
    if traced and res["trace"] is not None:
        t = res["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    return line
