"""Where the time goes in ``detect``, ``pseudo_labels`` and the train steps on the card.

    python -m probabilisticteacher_torch.profile_slice [--paths detect,mutual_step,...]

Runs at full width (VGG16, 8 classes, learnable anchors, AMP bf16, canvas
608 x 1344, seeded random weights; batch 8 for inference, 16 labeled + 16
unlabeled images for training) and prints the card's name and power limit, then
one JSON line per path:

- ``stages_ms``: device time of each stage (CUDA events, mean over the timed
  calls after a warm-up). Inference: backbone, RPN head, proposals (top-k,
  decode, RPN NMS), ROIAlign, box head + predictor, and the ROI tail (decode,
  class-aware NMS). Train steps: EMA, the teacher's ``pseudo_labels`` (mutual
  only), augmentation, student forward, backward, optimizer;
- ``call_ms``: host clock around a whole call that ends in a synchronize;
- ``kernels`` and ``ops``: device time over one call from ``torch.profiler``, by
  kernel name and by the ``aten::`` operator that launched it (inclusive), the
  12 largest of each, and the device's busy share of the profiled call's wall
  time (the profiler's own overhead lengthens that call). From the same trace,
  each kernel's device time over the whole call (:func:`kernel_ms`):
  ``roi_align_fwd_ms`` (K1: the teacher's and the student's ROIAlign in a
  mutual step; the ROI heads' in ``detect``/``pseudo_labels``), and for the
  train steps ``roi_align_bwd_ms`` (K2, in the backward) and ``nms_keep_ms``
  (K3: student RPN, teacher RPN, teacher class-aware NMS).

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .config import Arch, get_cfg
from .engine.steps import create_train_state, make_train_steps
from .modeling.detector import PTDetector
from .ops.roi_align_cuda import roi_align
from .solver import build_optimizer
from .structures import GroundTruth, ImageBatch, card_line


def _staged(det: PTDetector, batch: ImageBatch, training: bool):
    """One call of the path with an event pair around each stage."""
    a = det.arch
    marks = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.no_grad():
        marks[0][1].record()
        feat = det.features(batch)
        mark("backbone")
        obj, deltas = det.rpn_predict(feat)
        mark("rpn_head")
        anchors = det.anchors(feat.shape[1], feat.shape[2])
        props = det.predict_proposals(anchors, obj, deltas, batch.image_hw, training,
                                      grid_hw=feat.shape[1:3])
        mark("proposals_topk_decode_nms")
        pooled = roi_align(feat, props.boxes, 1.0 / a.stride, a.pooler_resolution,
                           a.pooler_sampling_ratio)
        mark("roi_align")
        det.predictor(det.box_head(pooled))
        mark("box_head_predictor")
        det._roi_inference(feat, props, batch.image_hw)   # repeats ROIAlign + heads
        mark("roi_inference_total")
    torch.cuda.synchronize()
    out = {}
    for (_, prev), (name, ev) in zip(marks, marks[1:]):
        out[name] = prev.elapsed_time(ev)
    out["roi_tail_decode_class_nms"] = (out.pop("roi_inference_total")
                                        - out["roi_align"] - out["box_head_predictor"])
    return out


BATCH, REPS = 8, 5
TRAIN_N, GT_PER_IMAGE = 16, 20
PATHS = ("detect", "pseudo_labels", "burnin_step", "mutual_step")


def profile_call(fn):
    """Device time by kernel and by ``aten::`` operator over one call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    op_rows = [(e.key, e.device_time_total / 1e3) for e in events if e.key.startswith("aten::")]
    # the kernels themselves, not the operators and autograd ranges that enclose them
    kernel_rows = [(e.key, e.device_time_total / 1e3) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in kernel_rows)
    return {"profiled_call_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "kernels": [[k[:80], t] for k, t in kernel_rows[:12]],
            "ops": [[k, t] for k, t in op_rows[:12]]}, kernel_rows


# the CUDA kernels' names in the profiler's rows: K1, K2, K3
KERNEL_ROWS = {"roi_align_fwd_ms": "roi_align_fwd_kernel",
               "roi_align_bwd_ms": "roi_align_bwd_kernel",
               "nms_keep_ms": "nms_keep_kernel"}


def kernel_ms(kernel_rows, name: str) -> float:
    """Device ms of the profiler rows (kernel name, ms) whose name holds ``name``:
    one kernel's time summed over its instantiations."""
    return sum(t for k, t in kernel_rows if name in k)


def _host_ms(fn, reps):
    calls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
    return calls


def _inference(path, det, batch, card):
    fn, training = (det.detect, False) if path == "detect" else (det.pseudo_labels, True)
    fn(batch)
    _staged(det, batch, training)
    stages = [_staged(det, batch, training) for _ in range(REPS)]
    mean = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
    calls = _host_ms(lambda: fn(batch), REPS)
    prof, kernel_rows = profile_call(lambda: fn(batch))
    return {"path": path, "batch": BATCH, "card": card, "stages_ms": mean,
            "roi_align_fwd_ms": kernel_ms(kernel_rows, KERNEL_ROWS["roi_align_fwd_ms"]),
            "call_ms": calls, **prof}


def _train_data(cfg, gen):
    """16 labeled images with 20 random boxes each and 16 unlabeled ones, random
    pixels on the full canvas."""
    h, w = cfg.INPUT.CANVAS.WIDE
    dev = "cuda"
    hw = torch.tensor([[600.0, 1200.0]] * TRAIN_N, device=dev)
    limg = ImageBatch(torch.rand(TRAIN_N, h, w, 3, device=dev, generator=gen) * 255, hw)
    uimg = ImageBatch(torch.rand(TRAIN_N, h, w, 3, device=dev, generator=gen) * 255, hw)
    wh = 24 + torch.rand(TRAIN_N, GT_PER_IMAGE, 2, device=dev, generator=gen) * 360
    xy = torch.rand(TRAIN_N, GT_PER_IMAGE, 2, device=dev, generator=gen) * (
        torch.tensor([1200.0, 600.0], device=dev) - wh)
    gt = GroundTruth(torch.cat([xy, xy + wh], -1),
                     torch.randint(0, 8, (TRAIN_N, GT_PER_IMAGE), device=dev, generator=gen,
                                   dtype=torch.int32),
                     torch.ones(TRAIN_N, GT_PER_IMAGE, dtype=torch.bool, device=dev))
    return limg, gt, uimg


def _train(path, cfg, card):
    cfg = cfg.clone()
    cfg.merge_from_list(["UNSUPNET.BURN_UP_STEP", "0"])   # mutual steps from the start
    student = PTDetector(Arch.from_cfg(cfg), device="cuda")
    student.init(seed=0)
    state = create_train_state(student, build_optimizer(cfg, student))
    burnin, mutual = make_train_steps(cfg, student)
    gen = torch.Generator(device="cuda").manual_seed(0)
    limg, gt, uimg = _train_data(cfg, gen)
    args = (limg, gt) if path == "burnin_step" else (limg, gt, uimg)
    step = burnin if path == "burnin_step" else mutual

    def one(mark=None):
        nonlocal state
        if mark is None:
            state, _ = step(state, *args, gen)
        else:
            state, _ = step(state, *args, gen, mark)

    def staged():
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        one(mark)
        torch.cuda.synchronize()
        return {name: prev.elapsed_time(ev) for (_, prev), (name, ev) in zip(marks, marks[1:])}

    torch.cuda.reset_peak_memory_stats()
    one()
    one()
    stages = [staged() for _ in range(REPS)]
    mean = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
    calls = _host_ms(one, REPS)
    prof, kernel_rows = profile_call(one)
    n_img = TRAIN_N if path == "burnin_step" else 2 * TRAIN_N
    return {"path": path, "labeled": TRAIN_N, "unlabeled": 0 if path == "burnin_step" else TRAIN_N,
            "card": card, "stages_ms": mean,
            **{key: kernel_ms(kernel_rows, name) for key, name in KERNEL_ROWS.items()},
            "call_ms": calls,
            "img_per_s": n_img / (sum(calls) / len(calls) / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"comma-separated subset of {', '.join(PATHS)}")
    paths = ap.parse_args(argv).paths.split(",")
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
                         "SOLVER.AMP.ENABLED", "True"])
    name = torch.cuda.get_device_name(0)
    det, batch = None, None
    for path in paths:
        if path in ("detect", "pseudo_labels"):
            if det is None:
                det = PTDetector(Arch.from_cfg(cfg), device="cuda").eval()
                det.init(seed=0)
                h, w = cfg.INPUT.CANVAS.WIDE
                gen = torch.Generator(device="cuda").manual_seed(0)
                batch = ImageBatch(torch.rand(BATCH, h, w, 3, device="cuda", generator=gen) * 255,
                                   torch.tensor([[600.0, 1200.0]] * BATCH, device="cuda"))
            out = _inference(path, det, batch, name)
        elif path in ("burnin_step", "mutual_step"):
            out = _train(path, cfg, name)
            torch.cuda.empty_cache()
        else:
            raise SystemExit(f"profile_slice: unknown path {path!r}; choose from {PATHS}")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
