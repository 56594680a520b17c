"""Where the time goes in ``detect`` and ``pseudo_labels`` on the card.

    python -m probabilisticteacher_torch.profile_slice

Runs the full-width slice (VGG16, 8 classes, learnable anchors, AMP bf16, canvas
608 x 1344, seeded random weights) and prints the card's name and power limit,
then one JSON line per path:

- ``stages_ms``: device time of each stage (CUDA events, mean over 5 calls
  after a warm-up): backbone, RPN head, proposals (top-k, decode, RPN NMS),
  ROIAlign, box head + predictor, and the ROI tail (decode, class-aware NMS);
- ``call_ms``: host clock around a whole call that ends in a synchronize;
- ``kernels`` and ``ops``: device time over one call from ``torch.profiler``, by
  kernel name and by the ``aten::`` operator that launched it (inclusive), the
  12 largest of each, and the device's busy share of the profiled call's wall
  time (the profiler's own overhead lengthens that call).

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from .config import Arch, get_cfg
from .modeling.detector import PTDetector
from .ops.roi_align_cuda import roi_align
from .structures import ImageBatch


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
        props = det.predict_proposals(anchors, obj, deltas, batch.image_hw, training)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
                         "SOLVER.AMP.ENABLED", "True"])
    det = PTDetector(Arch.from_cfg(cfg), device="cuda").eval()
    det.init(seed=0)
    h, w = cfg.INPUT.CANVAS.WIDE
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = ImageBatch(torch.rand(BATCH, h, w, 3, device="cuda", generator=gen) * 255,
                       torch.tensor([[600.0, 1200.0]] * BATCH, device="cuda"))
    for path, fn, training in (("detect", det.detect, False),
                               ("pseudo_labels", det.pseudo_labels, True)):
        fn(batch)
        _staged(det, batch, training)
        stages = [_staged(det, batch, training) for _ in range(REPS)]
        mean = {k: sum(s[k] for s in stages) / len(stages) for k in stages[0]}
        calls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
                if e.device_time_total > 0]
        rows.sort(key=lambda kv: -kv[1])
        op_rows = [kv for kv in rows if kv[0].startswith("aten::")]
        kernel_rows = [kv for kv in rows if not kv[0].startswith(("aten::", "cuda"))]
        busy = sum(t for _, t in kernel_rows)
        print(json.dumps({
            "path": path, "batch": BATCH, "card": torch.cuda.get_device_name(0),
            "stages_ms": mean, "call_ms": calls,
            "profiled_call_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "kernels": [[k[:80], t] for k, t in kernel_rows[:12]],
            "ops": [[k, t] for k, t in op_rows[:12]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
