#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (each failure exits non-zero; none is caught and passed over):

1. build both CUDA kernels with nvcc (one process per source, started together)
   and print the card's name and power limit;
2. ROIAlign kernel vs its plain PyTorch version at the teacher-pass shape,
   (8, 2000) ROIs on an (8, 38, 84, 512) map, in bf16 (tolerance 2e-2 * max|F|:
   the plain version rounds its interpolation matrices and intermediate to bf16,
   as the JAX package does) and f32 (1e-5 * max|F|), with boxes that run off the
   map and degenerate boxes;
3. NMS kernel vs its plain version at 8 x 12000 -> 2000 @ 0.7 and class-aware
   8 x 16000 -> 100 @ 0.5, with bf16-quantised (tied) scores, duplicate boxes and
   chains: indices and valid masks exactly equal;
4. the inference slice at full width (VGG16, 8 classes, learnable anchors, AMP
   bf16, canvas 608 x 1344, batch 8, seeded random weights): ``detect``,
   ``pseudo_labels`` and ``Predictor`` a few times each, each path driven with the
   kernels' launch counts set to 0 just before it and read just after; outputs
   finite and of their static shapes; then the card's slice against the CPU's
   plain path in f32 on a small input;
5. one JSON line of the kernels' launches, error, time (CUDA events), bound and
   plain-version time. Neither kernel has one PyTorch call that computes the same
   function (core PyTorch has no ROIAlign or NMS), so ``library_ms`` is null.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.ops import _build, nms_cuda, roi_align_cuda
from probabilisticteacher_torch.ops import nms as plain_nms
from probabilisticteacher_torch.ops.boxes import pairwise_iou
from probabilisticteacher_torch.ops.roi_align import roi_align_batched
from probabilisticteacher_torch.predictor import Predictor
from probabilisticteacher_torch.structures import ImageBatch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
IOU_OPS = 13                   # f32 operations of one IoU and its comparison
KERNELS = (roi_align_cuda.KERNEL, nms_cuda.KERNEL)
N, CANVAS, FEAT = 8, (608, 1344), (38, 84, 512)
# (label, K, max_keep, IoU threshold, classes): the RPN NMS of pseudo_labels and
# the class-aware NMS of its ROI inference
NMS_CASES = (("rpn", 12000, 2000, 0.7, 0), ("class", 16000, 100, 0.5, 8))
PREDICTOR_HW = (600, 1200)     # resizes to itself: no PIL
IMAGE_HW = ((600, 1200), (608, 1344), (600, 800), (450, 1344),
            (608, 1000), (500, 1100), (600, 1333), (333, 600))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------- phase 2
def roi_boxes(gen: torch.Generator, n: int, r: int, h: int, w: int) -> torch.Tensor:
    """Proposal-like boxes on an (h, w) stride-16 map, plus edge and degenerate ones."""
    img_w, img_h = w * 16.0, h * 16.0
    xy = torch.rand(n, r, 2, generator=gen) * torch.tensor([img_w + 64, img_h + 64]) - 32
    wh = torch.rand(n, r, 2, generator=gen) ** 2 * torch.tensor([img_w / 2, img_h / 2]) + 4
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 0] = torch.tensor([-60.0, -60.0, img_w + 60, img_h + 60])      # over every edge
    boxes[:, 1] = torch.tensor([img_w + 40, 8.0, img_w + 90, 90.0])          # wholly outside
    boxes[:, 2] = torch.tensor([100.0, 100.0, 100.0, 180.0])                 # zero width
    boxes[:, 3] = torch.tensor([200.0, 150.0, 190.0, 140.0])                 # inverted
    boxes[:, 4] = torch.tensor([img_w - 10, img_h - 10, img_w + 30, img_h + 30])
    boxes[:, 5] = torch.tensor([-30.0, -30.0, 5.0, 5.0])                     # top-left corner
    return boxes


def phase_roi_align(dev) -> dict:
    gen = torch.Generator().manual_seed(1)
    h, w, c = FEAT
    r = 2000
    boxes = roi_boxes(gen, N, r, h, w).to(dev)
    feat32 = torch.randn(N, h, w, c, generator=gen).to(dev)
    result = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        feat = feat32.to(dtype)
        got = roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2)
        want = roi_align_batched(feat, boxes, 1.0 / 16, 7, 2)
        torch.cuda.synchronize()
        fmax = feat.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        log(f"[roi_align] {str(dtype)[6:]}: max|kernel - plain| = {err!r} "
            f"(limit {tol} * max|F| = {tol * fmax!r})")
        check(got.shape == (N, r, 7, 7, c) and got.dtype == dtype, "roi_align output shape")
        check(bool(torch.isfinite(got).all()), "roi_align output not finite")
        check(err <= tol * fmax, f"roi_align {dtype} differs from its plain version")
        result[str(dtype)[6:]] = err
    feat = feat32.to(torch.bfloat16)
    ms = cuda_ms(lambda: roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2), reps=20)
    plain_ms = cuda_ms(lambda: roi_align_batched(feat, boxes, 1.0 / 16, 7, 2), reps=3, warm=1)
    nbytes = feat.numel() * 2 + boxes.numel() * 4 + N * r * 49 * c * 2
    ops = N * r * 49 * c * 33          # 4 samples x 4 taps x (mul + add), then the mean
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[roi_align] bf16 (8, 2000) ROIs: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({nbytes} B, {ops} f32 ops)")
    return {"name": "roi_align_fwd", "route": "cuda",
            "source": "probabilisticteacher_torch/csrc/roi_align_fwd.cu",
            "replaces": "probabilisticteacher_tpu/ops/roi_align_pallas.py:70",
            "max_abs_err": result["bfloat16"], "max_abs_err_f32": result["float32"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations",
            "library_ms": None, "shape": "features (8, 38, 84, 512) bf16, boxes (8, 2000, 4)"}


# --------------------------------------------------------------------- phase 3
def nms_case(gen: torch.Generator, n: int, k: int):
    """Clustered proposal-like boxes, bf16-rounded scores (ties), duplicates, chains."""
    centers = torch.rand(n, k // 25 + 1, 2, generator=gen) * torch.tensor([1344.0, 608.0])
    pick = torch.randint(0, centers.shape[1], (n, k), generator=gen)
    xy = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.randn(n, k, 2, generator=gen) * 20
    wh = torch.exp(torch.randn(n, k, 2, generator=gen) * 0.6 + 4.0)
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.sigmoid(torch.randn(n, k, generator=gen) * 2).to(torch.bfloat16).float()
    boxes[:, 100:140] = boxes[:, 99:100]                  # duplicates with tied scores
    scores[:, 100:140] = scores[:, 99:100]
    step = torch.arange(30, dtype=torch.float32)[:, None] * 9.0
    boxes[:, 200:230] = torch.cat([step, step * 0, step + 30, step * 0 + 30], 1)  # a chain
    scores[:, 200:230] = torch.linspace(0.99, 0.98, 30)
    valid = torch.rand(n, k, generator=gen) > 0.05
    return boxes, scores, valid


def iou_pairs(boxes_s, keep, valid_s, thresh) -> int:
    """IoU comparisons this data needs: each valid row against every kept row ahead of
    it, up to and including the first kept row that suppresses it."""
    total = 0
    for i in range(boxes_s.shape[0]):
        kept = torch.nonzero(keep[i]).squeeze(1)
        if kept.numel() == 0:
            continue
        rows = torch.arange(boxes_s.shape[1], device=boxes_s.device)
        hit = (pairwise_iou(boxes_s[i, kept], boxes_s[i]) > thresh) & (kept[:, None] < rows)
        first = torch.where(hit.any(0), hit.to(torch.int8).argmax(0), kept.numel())
        ahead = torch.searchsorted(kept, rows)            # kept rows before each row
        need = torch.minimum(ahead, first + 1)
        total += int(need[valid_s[i]].sum())
    return total


def phase_nms(dev) -> dict:
    gen = torch.Generator().manual_seed(2)
    out = {}
    for label, k, max_keep, thresh, classes in NMS_CASES:
        boxes, scores, valid = (x.to(dev) for x in nms_case(gen, N, k))
        if classes:
            cls = torch.randint(0, classes, (N, k), generator=gen).to(dev)
            got = nms_cuda.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
            want = plain_nms.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
            boxes = plain_nms.class_offset_boxes(boxes, cls, valid)
        else:
            got = nms_cuda.nms(boxes, scores, valid, thresh, max_keep)
            want = plain_nms.nms(boxes, scores, valid, thresh, max_keep)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        kept = int(got[1].sum())
        log(f"[nms] {label} {N}x{k}->{max_keep} @{thresh}: kept {kept}, "
            f"indices and valid masks equal: {same}")
        check(same, f"nms kernel keep set differs from the plain version ({label})")
        check(kept > 0, f"nms kept nothing ({label})")
        order, b_s, a_s, v_s = plain_nms.sort_by_score(boxes, scores, valid)
        keep = nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep)
        ms = cuda_ms(lambda: nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep), reps=10)
        plain_ms = cuda_ms(lambda: plain_nms.greedy_keep(b_s, a_s, v_s, thresh, max_keep),
                           reps=2, warm=1)
        pairs = iou_pairs(b_s, keep, v_s, thresh)
        nbytes = N * k * (16 + 4 + 1 + 1)
        ops = pairs * IOU_OPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        log(f"[nms] {label}: kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
            f"({pairs} IoU pairs, {nbytes} B)")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                      else "operations"}
    rpn = out["rpn"]
    return {"name": "nms_keep", "route": "cuda", "source": "probabilisticteacher_torch/csrc/nms.cu",
            "replaces": "probabilisticteacher_tpu/ops/nms_pallas.py:54", "max_abs_err": 0.0,
            "ms": rpn["ms"], "plain_ms": rpn["plain_ms"], "bound_ms": rpn["bound_ms"],
            "bound_by": rpn["bound_by"], "library_ms": None,
            "shape": "rpn 8x12000->2000 @0.7 (ms, plain_ms, bound_ms); class-aware below",
            "class_nms_8x16000_100": out["class"]}


# --------------------------------------------------------------------- phase 4
def full_width_cfg():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
                         "SOLVER.AMP.ENABLED", "True", "MODEL.VGG.DEPTH", "16",
                         "MODEL.ROI_HEADS.NUM_CLASSES", "8", "INPUT.CANVAS.WIDE", repr(CANVAS),
                         "INPUT.MIN_SIZE_TEST", str(PREDICTOR_HW[0])])
    return cfg


def drive(name, fn, calls: int):
    """Run one path ``calls`` times with the launch counts zeroed just before."""
    for k in KERNELS:
        k.launches = 0
    times, out = [], None
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k.symbol: k.launches for k in KERNELS}
    log(f"[slice] {name}: ms per call {times!r}; launches {counts}")
    for sym, c in counts.items():
        check(c > 0, f"{sym} was not launched on the {name} path")
    return out, times, counts


def check_outputs(name, out, n, d, k):
    for field, x in out._asdict().items():
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"{name}.{field} not finite")
    check(tuple(out.boxes.shape) == (n, d, 4) and tuple(out.valid.shape) == (n, d),
          f"{name} shapes {tuple(out.boxes.shape)}")
    check(tuple(out.logits.shape) == (n, d, k + 1), f"{name} logits shape")
    check(bool(out.valid.any()), f"{name} found nothing")


def phase_slice(dev) -> dict:
    cfg = full_width_cfg()
    arch = Arch.from_cfg(cfg)
    det = PTDetector(arch, device=dev).eval()
    det.init(seed=0)
    gen = torch.Generator().manual_seed(3)
    image = (torch.rand(N, *CANVAS, 3, generator=gen) * 255).to(dev)
    hw = torch.tensor(IMAGE_HW[:N], dtype=torch.float32, device=dev)
    batch = ImageBatch(image * (
        (torch.arange(CANVAS[0], device=dev)[None, :, None] < hw[:, 0, None, None])
        & (torch.arange(CANVAS[1], device=dev)[None, None, :] < hw[:, 1, None, None]))[..., None],
        hw)
    torch.cuda.reset_peak_memory_stats()
    dets, t_det, c_det = drive("detect", lambda: det.detect(batch), 3)
    check_outputs("detect", dets, N, arch.detections_per_image, arch.num_classes)
    pl, t_pl, c_pl = drive("pseudo_labels", lambda: det.pseudo_labels(batch), 3)
    check_outputs("pseudo_labels", pl, N, arch.detections_per_image, arch.num_classes)

    pred = Predictor(cfg, state_dict=det.state_dict(), device=dev)
    rng = np.random.RandomState(4)
    images = [rng.randint(0, 256, (*PREDICTOR_HW, 3), dtype=np.uint8) for _ in range(2)]
    res, t_pr, c_pr = drive("Predictor", lambda: [pred(im) for im in images], 2)
    for r in res:
        check(all(np.isfinite(v).all() for v in r.values()), "Predictor output not finite")
        check(len(r["scores"]) > 0, "Predictor found nothing")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[slice] peak device memory {peak!r} GiB")
    return {"detect_ms": t_det, "pseudo_labels_ms": t_pl,
            "predictor_ms_per_2_images": t_pr,
            "calls": {"detect": len(t_det), "pseudo_labels": len(t_pl),
                      "predictor": len(t_pr) * len(images)},
            "launches": {"detect": c_det, "pseudo_labels": c_pl, "predictor": c_pr},
            "peak_gib": peak}


def phase_reference(dev) -> None:
    """The card's slice against the CPU's plain path, f32, on a small input.

    Full-width VGG16 heads, 2 images of 96 x 160. Features and head outputs agree
    within 1e-3 of their scale; detections from the same features and proposals
    agree in mask and class, with boxes within 1e-2 and scores within 1e-4.
    Class and objectness weights are scaled up so scores are not near ties.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = Arch(vgg_depth=16, num_classes=8, learnable_anchors=True,
                rpn_pre_nms_topk=(600, 1200), rpn_post_nms_topk=(100, 200))
    cpu = PTDetector(arch, device="cpu").eval()
    sd = cpu.init(seed=5)
    with torch.no_grad():
        sd["predictor.cls_score.weight"].mul_(40)
        sd["rpn_head.objectness.weight"].mul_(30)
        sd["predictor.bbox_pred.weight"].mul_(10)
    gpu = PTDetector(arch, device=dev).eval()
    gpu.load_state_dict(sd)
    gen = torch.Generator().manual_seed(6)
    img = torch.rand(2, 96, 160, 3, generator=gen) * 255
    hw = torch.tensor([[96.0, 160.0], [80.0, 120.0]])
    with torch.no_grad():
        f_c = cpu.features(ImageBatch(img, hw))
        f_g = gpu.features(ImageBatch(img.to(dev), hw.to(dev)))
        scale = f_c.abs().max().item()
        err = (f_g.cpu() - f_c).abs().max().item()
        log(f"[reference] features: max|card - cpu| = {err!r} (scale {scale!r})")
        check(err <= 1e-3 * scale, "features differ from the CPU path")
        f = f_g.cpu()
        obj_c, d_c = cpu.rpn_predict(f)
        obj_g, d_g = gpu.rpn_predict(f.to(dev))
        check((obj_g.cpu() - obj_c).abs().max().item() <= 1e-3 * obj_c.abs().max().item(),
              "objectness differs from the CPU path")
        anchors = cpu.anchors(f.shape[1], f.shape[2])
        props = cpu.predict_proposals(anchors, obj_c, d_c, hw, training=False)
        props_g = type(props)(*(x.to(dev) for x in props))
        want = cpu._roi_inference(f, props, hw)
        got = gpu._roi_inference(f.to(dev), props_g, hw.to(dev))
    v = want.valid
    same = torch.equal(got.valid.cpu(), v) and torch.equal(got.classes.cpu()[v], want.classes[v])
    box_err = (got.boxes.cpu()[v] - want.boxes[v]).abs().max().item()
    score_err = (got.scores.cpu()[v] - want.scores[v]).abs().max().item()
    log(f"[reference] detections from the same proposals: {int(v.sum())} valid, masks and "
        f"classes equal: {same}, max box err {box_err!r}, max score err {score_err!r}")
    check(bool(v.any()) and same and box_err <= 1e-2 and score_err <= 1e-4,
          "card detections differ from the CPU path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build(KERNELS)
    build_s = time.perf_counter() - t0
    for k in KERNELS:
        log(f"[build] {k.source}: {(k.build_log or 'cached').strip()}")
    log(f"[build] both kernels built in {build_s!r} s")
    log(f"[card] {card_line()}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False

    k_roi = phase_roi_align(dev)
    k_nms = phase_nms(dev)
    sl = phase_slice(dev)
    phase_reference(dev)

    for entry, sym in ((k_roi, roi_align_cuda.KERNEL.symbol), (k_nms, nms_cuda.KERNEL.symbol)):
        per = {path: c[sym] for path, c in sl["launches"].items()}
        entry["launches"] = sum(per.values())
        entry["launches_by_path"] = per
        entry["calls_by_path"] = sl["calls"]
    log(json.dumps({"slice": {k: v for k, v in sl.items() if k not in ("launches", "calls")},
                    "build_s": build_s, "total_s": time.perf_counter() - t0}))
    log("[kernels] library_ms is null for both: core PyTorch has no ROIAlign or NMS "
        "call (torchvision is not installed), so no single library call computes either")
    log(f"[card] {card_line()}")
    log(json.dumps({"kernels": [k_roi, k_nms]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
