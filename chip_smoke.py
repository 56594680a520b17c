#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases (each failure exits non-zero; none is caught and passed over):

1. build the three CUDA kernels with nvcc (one process per source, started
   together) and print the card's name and power limit;
2. ROIAlign kernel vs its plain PyTorch version at the teacher-pass shape,
   (8, 2000) ROIs on an (8, 38, 84, 512) map, in bf16 (tolerance 2e-2 * max|F|:
   the plain version rounds its interpolation matrices and intermediate to bf16,
   as the JAX package does) and f32 (1e-5 * max|F|), with boxes that run off the
   map and degenerate boxes;
3. NMS kernel vs its plain version at the inference shapes, 8 x 12000 -> 2000
   @ 0.7 and class-aware 8 x 16000 -> 100 @ 0.5, and at the train step's own:
   the student's RPN 48 x 12000 -> 2000, the teacher's RPN 16 x 12000 -> 2000
   and its class-aware 16 x 16000 -> 100; clustered boxes that fill the RPN's
   budget, bf16-quantised (tied) scores, duplicate boxes and chains: indices and
   valid masks exactly equal;
4. the inference slice at full width (VGG16, 8 classes, learnable anchors, AMP
   bf16, canvas 608 x 1344, batch 8, seeded random weights): ``detect``,
   ``pseudo_labels`` and ``Predictor`` a few times each, each path driven with the
   kernels' launch counts set to 0 just before it and read just after; outputs
   finite and of their static shapes; then the card's slice against the CPU's
   plain path in f32 on a small input;
5. ROIAlign backward kernel vs its plain version at the recipe's student shape,
   (48, 512) ROIs on a (48, 38, 84, 512) map, bf16 (2e-2 * max|dF|) and f32
   (1e-5 * max|dF|), with the edge and degenerate boxes of phase 2 and zero
   gradient rows; and how far two runs of the kernel differ (f32 atomics);
6. the train steps at full width (the recipe ``configs/pt/final_c2f.yaml``: VGG16,
   8 classes, learnable anchors, AMP bf16, canvas 608 x 1344, 16 labeled + 16
   unlabeled images; seeded random weights, random pixels, 20 random boxes per
   labeled image): ``burnin_step`` x2 with ``BURN_UP_STEP`` = 2, then
   ``mutual_step`` x3 (the boundary copy, then two EMA steps), each path driven
   with the launch counts set to 0 just before it and read just after, every
   kernel launched on both; losses and metrics finite, the student moved, the
   teacher equal to the pre-step student after the boundary step; ms per step,
   images per second and peak memory;
7. one ``student_losses`` value and gradient on the card against the CPU, f32 with
   TF32 off, on a small input with the same weights and draws: losses within
   1e-4 relative, every parameter gradient (``anchor_wh`` included) within 1e-3 of
   its scale, its L2 norm;
8. one JSON line of the kernels' launches, error, time (CUDA events), bound and
   plain-version time. No kernel has one PyTorch call that computes the same
   function (core PyTorch has no ROIAlign, ROIAlign backward or NMS), so
   ``library_ms`` is null.

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
from probabilisticteacher_torch.engine.steps import create_train_state, make_train_steps
from probabilisticteacher_torch.modeling.detector import LossDraws, PTDetector
from probabilisticteacher_torch.ops import _build, nms_cuda, roi_align_cuda
from probabilisticteacher_torch.ops import nms as plain_nms
from probabilisticteacher_torch.ops.boxes import pairwise_iou
from probabilisticteacher_torch.ops.roi_align import (batched_pool_matrices, roi_align_batched,
                                                      roi_align_bwd_plain)
from probabilisticteacher_torch.ops.sampling import SampleDraws
from probabilisticteacher_torch.predictor import Predictor
from probabilisticteacher_torch.solver import build_optimizer
from probabilisticteacher_torch.structures import GroundTruth, ImageBatch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
IOU_OPS = 13                   # f32 operations of one IoU and its comparison
KERNELS = (roi_align_cuda.KERNEL, roi_align_cuda.BWD_KERNEL, nms_cuda.KERNEL)
INFERENCE_KERNELS = (roi_align_cuda.KERNEL, nms_cuda.KERNEL)
N, CANVAS, FEAT = 8, (608, 1344), (38, 84, 512)
TRAIN_N = 16                   # IMG_PER_BATCH_LABEL = IMG_PER_BATCH_UNLABEL of the recipe
TRAIN_ROIS = (48, 512)         # the fused student pass: 2 x 16 labeled + 16 unlabeled images
GT_PER_IMAGE = 20
# (label, images, K, max_keep, IoU threshold, classes): the RPN NMS of
# pseudo_labels and the class-aware NMS of its ROI inference at batch 8, then the
# three calls of one mutual step: the student's RPN (2 x 16 labeled views + 16
# unlabeled images), the teacher's RPN and the teacher's class-aware NMS
NMS_CASES = (("rpn", 8, 12000, 2000, 0.7, 0), ("class", 8, 16000, 100, 0.5, 8),
             ("rpn_student", 48, 12000, 2000, 0.7, 0), ("rpn_teacher", 16, 12000, 2000, 0.7, 0),
             ("class_teacher", 16, 16000, 100, 0.5, 8))
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
    for label, n, k, max_keep, thresh, classes in NMS_CASES:
        boxes, scores, valid = (x.to(dev) for x in nms_case(gen, n, k))
        if classes:
            cls = torch.randint(0, classes, (n, k), generator=gen).to(dev)
            got = nms_cuda.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
            want = plain_nms.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
            boxes = plain_nms.class_offset_boxes(boxes, cls, valid)
        else:
            got = nms_cuda.nms(boxes, scores, valid, thresh, max_keep)
            want = plain_nms.nms(boxes, scores, valid, thresh, max_keep)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        kept = int(got[1].sum())
        log(f"[nms] {label} {n}x{k}->{max_keep} @{thresh}: kept {kept} "
            f"({kept / n!r} per image), indices and valid masks equal: {same}")
        check(same, f"nms kernel keep set differs from the plain version ({label})")
        check(kept > 0, f"nms kept nothing ({label})")
        order, b_s, a_s, v_s = plain_nms.sort_by_score(boxes, scores, valid)
        keep = nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep)
        ms = cuda_ms(lambda: nms_cuda.nms_keep(b_s, a_s, v_s, thresh, max_keep), reps=10)
        # the plain scan takes ~1 s at 48 images: one timed call there
        plain_ms = cuda_ms(lambda: plain_nms.greedy_keep(b_s, a_s, v_s, thresh, max_keep),
                           reps=1 if n > 16 else 2, warm=0 if n > 16 else 1)
        pairs = iou_pairs(b_s, keep, v_s, thresh)
        nbytes = n * k * (16 + 4 + 1 + 1)
        ops = pairs * IOU_OPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        log(f"[nms] {label}: kernel {ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
            f"({pairs} IoU pairs, {nbytes} B)")
        out[label] = {"images": n, "k": k, "max_keep": max_keep, "thresh": thresh,
                      "kept": kept, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                      else "operations"}
    rpn = out["rpn"]
    return {"name": "nms_keep", "route": "cuda", "source": "probabilisticteacher_torch/csrc/nms.cu",
            "replaces": "probabilisticteacher_tpu/ops/nms_pallas.py:54", "max_abs_err": 0.0,
            "ms": rpn["ms"], "plain_ms": rpn["plain_ms"], "bound_ms": rpn["bound_ms"],
            "bound_by": rpn["bound_by"], "library_ms": None,
            "shape": "rpn 8x12000->2000 @0.7 (ms, plain_ms, bound_ms); every case in cases",
            "cases": out}


# --------------------------------------------------------------------- phase 4
def full_width_cfg():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
                         "SOLVER.AMP.ENABLED", "True", "MODEL.VGG.DEPTH", "16",
                         "MODEL.ROI_HEADS.NUM_CLASSES", "8", "INPUT.CANVAS.WIDE", repr(CANVAS),
                         "INPUT.MIN_SIZE_TEST", str(PREDICTOR_HW[0])])
    return cfg


def drive(name, fn, calls: int, required=INFERENCE_KERNELS):
    """Run one path ``calls`` times with the launch counts zeroed just before; every
    kernel of ``required`` must have launched."""
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
    log(f"[path] {name}: ms per call {times!r}; launches {counts}")
    for k in required:
        check(counts[k.symbol] > 0, f"{k.symbol} was not launched on the {name} path")
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


# --------------------------------------------------------------------- phase 5
def bwd_taps(wy: torch.Tensor, wx: torch.Tensor, g: torch.Tensor) -> int:
    """(bin, map position) pairs with a non-zero weight and a non-zero gradient row:
    the scatter this run's data needs."""
    ny = (wy != 0).sum(-1)                                   # (N, R, p) rows per bin
    nx = (wx != 0).sum(-1)                                   # (N, R, p) columns per bin
    live = g.flatten(2).ne(0).any(-1)                        # (N, R) rows with gradient
    per_roi = ny.sum(-1) * nx.sum(-1)                        # sum_q sum_x ny[q] nx[x]
    return int((per_roi * live).sum())


def phase_roi_align_bwd(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(7)
    h, w, c = FEAT
    n, r = TRAIN_ROIS
    boxes = roi_boxes(torch.Generator().manual_seed(7), n, r, h, w).to(dev)
    g32 = torch.randn(n, r, 7, 7, c, generator=gen, device=dev)
    g32[:, r - 40:] = 0                    # padded ROI rows: the masked losses give them 0
    result, rerun = {}, {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        g = g32.to(dtype)
        got = roi_align_cuda.roi_align_backward(g, boxes, (n, h, w, c), dtype, 1.0 / 16, 7, 2)
        again = roi_align_cuda.roi_align_backward(g, boxes, (n, h, w, c), dtype, 1.0 / 16, 7, 2)
        wy, wx = batched_pool_matrices(boxes, h, w, 1.0 / 16, 7, 2, dtype)
        want = roi_align_bwd_plain(wy, wx, g)
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        rerun[str(dtype)[6:]] = (got.float() - again.float()).abs().max().item()
        log(f"[roi_align_bwd] {str(dtype)[6:]}: max|kernel - plain| = {err!r} (limit {tol} * "
            f"max|dF| = {tol * scale!r}); two kernel runs differ by {rerun[str(dtype)[6:]]!r}")
        check(got.shape == (n, h, w, c) and got.dtype == dtype, "roi_align_bwd output shape")
        check(bool(torch.isfinite(got).all()), "roi_align_bwd output not finite")
        check(err <= tol * scale, f"roi_align_bwd {dtype} differs from its plain version")
        result[str(dtype)[6:]] = err
        del got, again, want
    g = g32.to(torch.bfloat16)
    del g32
    wy, wx = batched_pool_matrices(boxes, h, w, 1.0 / 16, 7, 2, torch.bfloat16)
    ms = cuda_ms(lambda: roi_align_cuda.roi_align_backward(g, boxes, (n, h, w, c), torch.bfloat16,
                                                           1.0 / 16, 7, 2), reps=10)
    plain_ms = cuda_ms(lambda: roi_align_bwd_plain(wy, wx, g), reps=3, warm=1)
    taps = bwd_taps(wy, wx, g)
    map_elems = n * h * w * c
    # the function's bytes: g and the boxes read, dF written; the f32 scratch
    # (zeroed, then read by the cast) is this design's cost, reported beside them
    nbytes = g.numel() * 2 + boxes.numel() * 4 + map_elems * 2
    design_bytes = map_elems * 4 * 2
    ops = taps * c * 2                     # a multiply and an add per channel and tap
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[roi_align_bwd] bf16 (48, 512) ROIs: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({nbytes} B, {taps} taps, {ops} f32 ops); the f32 scratch "
        f"adds {design_bytes} B ({design_bytes / HBM_BYTES_PER_S * 1e3!r} ms)")
    return {"name": "roi_align_bwd", "route": "cuda",
            "source": "probabilisticteacher_torch/csrc/roi_align_bwd.cu",
            "replaces": "probabilisticteacher_tpu/ops/roi_align_pallas.py:228",
            "max_abs_err": result["bfloat16"], "max_abs_err_f32": result["float32"],
            "run_to_run_max_abs_diff": rerun,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "design_bytes": design_bytes,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations",
            "library_ms": None,
            "shape": "dOut (48, 512, 7, 7, 512) bf16 -> dF (48, 38, 84, 512), 40 zero rows"}


# --------------------------------------------------------------------- phase 6
def train_cfg():
    cfg = full_width_cfg()
    cfg.merge_from_list(["SOLVER.IMG_PER_BATCH_LABEL", str(TRAIN_N),
                         "SOLVER.IMG_PER_BATCH_UNLABEL", str(TRAIN_N),
                         "UNSUPNET.BURN_UP_STEP", "2"])
    return cfg


def train_batch(gen: torch.Generator, n: int, dev, labeled: bool):
    """Random pixels on the canvas (zero beyond each image's size) and, for labeled
    images, 20 random boxes inside each image with random classes."""
    hw = torch.tensor([IMAGE_HW[i % len(IMAGE_HW)] for i in range(n)], dtype=torch.float32)
    image = torch.rand(n, *CANVAS, 3, generator=gen) * 255
    inside = ((torch.arange(CANVAS[0])[None, :, None] < hw[:, 0, None, None])
              & (torch.arange(CANVAS[1])[None, None, :] < hw[:, 1, None, None]))
    batch = ImageBatch((image * inside[..., None]).to(dev), hw.to(dev))
    if not labeled:
        return batch
    wh = 24 + torch.rand(n, GT_PER_IMAGE, 2, generator=gen) * 360
    xy = torch.rand(n, GT_PER_IMAGE, 2, generator=gen) * (hw[:, None, [1, 0]] - wh).clamp(min=1)
    boxes = torch.cat([xy, xy + wh], -1).minimum(hw[:, None, [1, 0, 1, 0]])
    classes = torch.randint(0, 8, (n, GT_PER_IMAGE), generator=gen, dtype=torch.int32)
    gt = GroundTruth(boxes.to(dev), classes.to(dev),
                     torch.ones(n, GT_PER_IMAGE, dtype=torch.bool, device=dev))
    return batch, gt


def _finite(metrics) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in metrics.values())


def phase_train(dev) -> dict:
    cfg = train_cfg()
    arch = Arch.from_cfg(cfg)
    student = PTDetector(arch, device=dev)
    student.init(seed=0)
    state = create_train_state(student, build_optimizer(cfg, student))
    burnin, mutual = make_train_steps(cfg, student)
    gen = torch.Generator().manual_seed(8)
    limg, lgt = train_batch(gen, TRAIN_N, dev, labeled=True)
    uimg = train_batch(gen, TRAIN_N, dev, labeled=False)
    draws = torch.Generator(device=dev).manual_seed(9)
    start = {k: v.clone() for k, v in student.state_dict().items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = []

    def run(step_fn, *args):
        nonlocal state
        state, m = step_fn(state, *args, draws)
        metrics.append(m)

    _, t_burn, c_burn = drive("burnin_step", lambda: run(burnin, limg, lgt), 2, KERNELS)
    check(state.step == 2, "burn-in did not advance the step")
    check(all(_finite(m) for m in metrics), f"burn-in metrics not finite: {metrics[-1]}")
    teacher0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    check(all(torch.equal(v, start[k]) for k, v in teacher0.items()),
          "burn-in moved the teacher")
    moved = sum((v.float() - start[k].float()).abs().sum().item()
                for k, v in state.student.state_dict().items())
    check(moved > 0, "the student did not move in burn-in")

    pre = {k: v.clone() for k, v in state.student.state_dict().items()}
    _, t_b1, c_b1 = drive("mutual_step (boundary)", lambda: run(mutual, limg, lgt, uimg), 1,
                          KERNELS)
    check(all(torch.equal(v, pre[k]) for k, v in state.teacher.state_dict().items()),
          "after the boundary step the teacher is not the pre-step student")
    _, t_mut, c_mut = drive("mutual_step (EMA)", lambda: run(mutual, limg, lgt, uimg), 2,
                            KERNELS)
    check(state.step == 5, "the mutual steps did not advance the step")
    check(all(_finite(m) for m in metrics), f"mutual metrics not finite: {metrics[-1]}")
    check(float(metrics[-1]["num_pseudo_boxes"]) > 0, "the teacher made no pseudo-labels")
    check(float(metrics[-1]["loss_box_reg_unsup"]) > 0, "no unsupervised ROI box loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts_mut = {k: c_b1[k] + c_mut[k] for k in c_b1}
    burn_s, mut_s = t_burn[-1] / 1e3, sum(t_mut) / len(t_mut) / 1e3
    out = {"burnin_step_ms": t_burn, "mutual_step_ms": t_b1 + t_mut,
           "burnin_labeled_img_per_s": TRAIN_N / burn_s,
           "mutual_img_per_s": 2 * TRAIN_N / mut_s,
           "student_pass_images": {"burnin": 2 * TRAIN_N, "mutual": 3 * TRAIN_N},
           "peak_gib": peak,
           "last_metrics": {k: float(v) for k, v in metrics[-1].items()}}
    log(f"[train] burn-in ms per step {t_burn!r}; mutual {t_b1 + t_mut!r}; steady "
        f"{out['burnin_labeled_img_per_s']!r} labeled img/s (burn-in), "
        f"{out['mutual_img_per_s']!r} labeled+unlabeled img/s (mutual); peak {peak!r} GiB")
    log(f"[train] last metrics {json.dumps(out['last_metrics'])}")
    del state, student
    torch.cuda.empty_cache()
    return {"out": out, "launches": {"burnin_step": c_burn, "mutual_step": counts_mut},
            "calls": {"burnin_step": len(t_burn), "mutual_step": len(t_b1) + len(t_mut)}}


# --------------------------------------------------------------------- phase 7
TRAIN_REF_LOSS_TOL = 1e-4              # relative
TRAIN_REF_GRAD_TOL = 1e-3              # of each gradient's L2 norm


def train_reference_errors(dev) -> dict:
    """``student_losses`` value and gradient, card vs CPU, f32 with TF32 off: the
    largest relative loss error and the worst gradient error of its L2 norm.

    Full VGG16 widths on 4 labeled + 4 unlabeled images of 96 x 160 (the fused
    path), the CPU detector's own pseudo-labels, and draws made once and given to
    both. Class and objectness weights are scaled up so that scores are not near
    ties; proposals under 2 px are dropped, since box deltas against them amplify
    the ~1e-6 convolution differences past any tolerance.

    A gradient's scale is its L2 norm. Its largest single entry is no measure
    here: a ReLU input or a max-pool window that sits within rounding of a tie
    sends its cotangent elsewhere on the other device, and on the CPU alone a 1e-6
    relative change of the first convolution's weights moves the largest entry of
    a backbone gradient by 3e-3 of its largest value, while the L2 norm of the
    change stays near 3e-4 of the gradient's.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = Arch(vgg_depth=16, num_classes=8, learnable_anchors=True, rpn_min_size=2.0,
                rpn_pre_nms_topk=(600, 1200), rpn_post_nms_topk=(100, 200),
                rpn_batch_per_image=64, roi_batch_per_image=64, unsup_roi_budget=64)
    cpu = PTDetector(arch, device="cpu")
    sd = cpu.init(seed=5)
    with torch.no_grad():
        sd["predictor.cls_score.weight"].mul_(4)
        sd["rpn_head.objectness.weight"].mul_(10)
    gpu = PTDetector(arch, device=dev)
    gpu.load_state_dict(sd)
    gen = torch.Generator().manual_seed(10)
    nl, nu, g = 4, 4, 5
    hw = torch.tensor([[96.0, 160.0], [80.0, 120.0]] * 2)
    img_l, img_u = (torch.rand(n, 96, 160, 3, generator=gen) * 255 for n in (nl, nu))
    xy = torch.rand(nl, g, 2, generator=gen) * torch.tensor([100.0, 50.0])
    boxes = torch.cat([xy, xy + 12 + torch.rand(nl, g, 2, generator=gen) * 40], -1)
    gt = GroundTruth(boxes, torch.randint(0, 8, (nl, g), generator=gen, dtype=torch.int32),
                     torch.ones(nl, g, dtype=torch.bool))
    pseudo = cpu.pseudo_labels(ImageBatch(img_u, hw))
    anchors = 6 * 10 * cpu.A
    rows = arch.rpn_post_nms_topk[1] + g
    draws = LossDraws(SampleDraws(torch.rand(nl, anchors, generator=gen),
                                  torch.rand(nl, anchors, generator=gen)),
                      SampleDraws(torch.rand(nl, rows, generator=gen),
                                  torch.rand(nl, rows, generator=gen)))

    def run(det, d):
        def to(x):
            return type(x)(*(t.to(d) for t in x))
        sup, unsup = det.student_losses(ImageBatch(img_l.to(d), hw.to(d)), to(gt),
                                        ImageBatch(img_u.to(d), hw.to(d)), to(pseudo),
                                        LossDraws(to(draws.rpn), to(draws.roi)))
        losses = {**{k + "_sup": v for k, v in sup.items()},
                  **{k + "_unsup": v for k, v in unsup.items()}}
        sum(v for k, v in losses.items() if k.startswith("loss")).backward()
        grads = {k: p.grad.cpu() for k, p in det.named_parameters() if p.grad is not None}
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    want_l, want_g = run(cpu, "cpu")
    got_l, got_g = run(gpu, dev)
    loss_err = max(abs(got_l[k] - v) / max(abs(v), 1e-6) for k, v in want_l.items())
    grad_err = {k: ((got_g[k] - v).norm() / v.norm().clamp(min=1e-30)).item()
                for k, v in want_g.items()}
    max_abs = {k: ((got_g[k] - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
               for k, v in want_g.items()}
    worst = max(grad_err, key=grad_err.get)
    worst_abs = max(max_abs, key=max_abs.get)
    log(f"[train-reference] losses {json.dumps(want_l)}")
    log(f"[train-reference] max relative loss error {loss_err!r}; worst gradient error "
        f"{grad_err[worst]!r} of its L2 norm ({worst}); anchor_wh {grad_err['anchor_wh']!r}; "
        f"largest single-entry error {max_abs[worst_abs]!r} of the largest entry "
        f"({worst_abs})")
    check(set(got_g) == set(want_g) and "anchor_wh" in want_g,
          "card and CPU give gradients to different parameters")
    check(float(want_g["anchor_wh"].abs().sum()) > 0, "anchor_wh got no gradient")
    check(want_l["loss_box_reg_unsup"] > 0 and want_l["loss_box_reg_sup"] > 0,
          "the reference input exercises no ROI box loss")
    return {"loss_err": loss_err, "grad_err": grad_err[worst], "worst": worst}


def phase_train_reference(dev) -> None:
    errs = train_reference_errors(dev)
    check(errs["loss_err"] <= TRAIN_REF_LOSS_TOL, "card losses differ from the CPU path")
    check(errs["grad_err"] <= TRAIN_REF_GRAD_TOL, "card gradients differ from the CPU path")


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
    log(f"[build] {len(KERNELS)} kernels built in {build_s!r} s")
    log(f"[card] {card_line()}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False

    k_roi = phase_roi_align(dev)
    k_bwd = phase_roi_align_bwd(dev)
    k_nms = phase_nms(dev)
    sl = phase_slice(dev)
    phase_reference(dev)
    tr = phase_train(dev)
    phase_train_reference(dev)

    launches = {**sl["launches"], **tr["launches"]}
    calls = {**sl["calls"], **tr["calls"]}
    for entry, k in ((k_roi, roi_align_cuda.KERNEL), (k_bwd, roi_align_cuda.BWD_KERNEL),
                     (k_nms, nms_cuda.KERNEL)):
        per = {path: c[k.symbol] for path, c in launches.items()}
        entry["launches"] = sum(per.values())
        entry["launches_by_path"] = per
        entry["calls_by_path"] = calls
    log(json.dumps({"slice": {k: v for k, v in sl.items() if k not in ("launches", "calls")},
                    "train": tr["out"], "build_s": build_s,
                    "total_s": time.perf_counter() - t0}))
    log("[kernels] library_ms is null for all three: core PyTorch has no ROIAlign, ROIAlign "
        "backward or NMS call (torchvision is not installed), so no single library call "
        "computes any of them")
    log(f"[card] {card_line()}")
    log(json.dumps({"kernels": [k_roi, k_bwd, k_nms]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
