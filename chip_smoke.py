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
   map and degenerate boxes; then timed, bf16, at the train step's shapes too:
   the student's (48, 512) and the teacher's (16, 2000) ROIs, and the student's per
   rank of a 2-rank data-parallel step, (24, 512);
3. NMS kernel vs its plain version at the inference shapes, 8 x 12000 -> 2000
   @ 0.7 and class-aware 8 x 16000 -> 100 @ 0.5, and at the train step's own:
   the student's RPN 48 x 12000 -> 2000, the teacher's RPN 16 x 12000 -> 2000
   and its class-aware 16 x 16000 -> 100, and the student's RPN per rank of a
   2-rank step, 24 x 12000 -> 2000; clustered boxes that fill the RPN's
   budget, bf16-quantised (tied) scores, duplicate boxes and chains: indices and
   valid masks exactly equal;
4. the inference slice at full width (VGG16, 8 classes, learnable anchors, AMP
   bf16, canvas 608 x 1344, batch 8, seeded random weights): ``detect``,
   ``pseudo_labels`` and ``Predictor`` a few times each, each path driven with the
   kernels' launch counts set to 0 just before it and read just after; outputs
   finite and of their static shapes; then the card's slice against the CPU's
   plain path in f32 on a small input;
5. ROIAlign backward kernel vs its plain version at the train step's shapes,
   the student pass of a mutual step, (48, 512) ROIs on a (48, 38, 84, 512) map,
   and of a burn-in step, (32, 512), and both per rank of a 2-rank step,
   (24, 512) and (16, 512), bf16 (2e-2 * max|dF|) and f32
   (1e-5 * max|dF|), with the edge and degenerate boxes of phase 2 and zero
   gradient rows; two runs of the kernel must give the same dF bit for bit; each
   shape's time, bound and ``design_bytes`` (g read again by a second tile);
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
8. the port's CLI on the card, ``train_net.main`` in this process, with the recipe
   ``configs/pt/final_c2f.yaml`` unchanged (VGG16, 8 classes, AMP bf16, 16 + 16
   images, canvas 608 x 1344; random weights from ``SEED`` 0) on a synthetic VOC
   tree written to a temporary ``DETECTRON2_DATASETS`` root: the recipe's three
   splits, 32 labeled, 32 unlabeled and 16 val Cityscapes-sized (2048 x 1024)
   JPEGs with 20 boxes each, from a fixed seed. ``SOLVER.MAX_ITER`` 4 with
   ``BURN_UP_STEP`` 2, checkpoints every 2 and the dual eval at 4: 2 burn-in and 2
   mutual steps through the host loader and the stream prefetcher, then the
   final teacher eval. Checks: losses finite, ``metrics.json`` holds the
   iterations written, checkpoints at 2 and 4 with the ``last_checkpoint``
   marker, finite ``mAP50``, the EvalHook's teacher metrics equal to the final
   eval's (1e-6), and each kernel launched. Then ``--resume`` to 6 (it starts at
   4 with teacher, student and momentum equal to the saved ones bit for bit and
   takes 2 mutual steps), ``--eval-only`` of ``model_0000004`` (the student, as
   the root ``train_net.py`` evaluates) equal to the EvalHook's student metrics
   of the same weights (1e-6), and ``Predictor(checkpoint_path=...)`` on one val
   image equal to the teacher's ``detect`` on that image's canvas (1e-4 px).
   Prints the host decoder, ms per iteration with the loader in the loop, the
   loader's ``data_time``, the share of the step waiting on data and eval
   images/s;
9. data parallel (``parallel/mesh.py``): (a) two ranks share the card over gloo
   (NCCL refuses two ranks on one device), started with ``spawn``, joined with a
   time limit and killed on failure. In f32 with TF32 off, ``burnin_step`` and
   ``mutual_step``, each from the seeded weights, at the recipe's full width
   (global 16 + 16 images, 8 + 8 per rank; class and objectness weights scaled
   and proposals under 2 px dropped, as in phase 7) against one process over the
   global batch: metrics within 1e-4 relative, each summed gradient within 1e-3
   of its L2 norm (phase 7's limits). Then 3 bf16 mutual steps per rank: finite,
   the replicas bit-identical after each step; ms per step per rank and of the
   gradient all-reduce (the two ranks share the card, so this is no scaling
   figure). With two or more cards, the same comparison over NCCL across two
   cards. The phase prints the world sizes and backends it ran. (b) the CLI with
   ``--num-gpus <device count>`` on phase 8's tree: on one card a world of one
   through the launch path, in this process;
10. the opt-in levers at full width (bf16, 8 images for inference, 16 + 16 for a
   step), under each ``MODEL.RPN.NMS_IMPL`` of greedy, maxpool, maxpool_train and
   hybrid: ``predict_proposals`` (test and train budgets: valid, finite proposals
   inside their image; the NMS kernel launched exactly where the lever runs the
   exact NMS, on the hybrid's candidates too), ``detect``, ``pseudo_labels`` and one
   ``mutual_step``, with ms per call and K3's device ms from ``torch.profiler``;
   then one mutual step with ``MODEL.BACKBONE.REMAT`` off and on: gradients within
   1e-3 of their L2 norm, a lower peak memory with REMAT on, and both times;
11. the accuracy proxy's runner, ``probabilisticteacher_torch/accuracy_proxy.py``:
   its ``campaign`` at a small depth on a proxy written by
   ``scripts/make_daod_proxy.py`` (32 + 32 training and 8 + 8 val images of 480 x
   960), each stage's ``train_net.main`` in this process through the runner's own
   override list (the recipe at full width, VGG16, AMP bf16, 16 + 16 images,
   canvas 480 x 992): 20 source-only iterations, then 20 PT iterations from stage 1's
   final checkpoint with ``BURN_UP_STEP`` 10, evals every 10. Checks: losses and
   the eval metrics of each stage finite (the foggy and the clean val split in stage
   1; teacher, student and pseudo boxes in stage 2), stage 2's student and teacher
   loaded by ``MODEL.WEIGHTS`` equal to stage 1's final ones bit for bit, the teacher
   after step 10 equal to the student before it bit for bit, and each kernel launched
   in each stage. Prints each stage's iterations per second, data wait, eval
   images/s and peak memory; then each kernel against its plain version and timed at
   the proxy's shapes (a 30 x 62 map): K1 at (48, 512) and (16, 2000) ROIs, K2 at
   (48, 512) and (32, 512), K3 at 48 and 16 x 12000 -> 2000 and 16 x 16000 -> 100;
12. the bench entry, ``probabilisticteacher_torch/bench.py``: its worker in this
   process at the recipe's batch, ``--batch 16`` (16 + 16 images on the bench's
   608 x 1216 canvas, VGG16, AMP bf16, ``bench.py``'s random uint8 batches), 3
   windows of 3 iterations, with the launch counts set to 0 just before and read
   just after (``bench_worker``: K1, K2 and K3 each launched); the record's keys,
   ``value`` finite and equal to 4 x 16 / ``step_ms``, 0 < ``conv_mfu`` <= 1; then
   ``python -m probabilisticteacher_torch.bench --iters 4 --windows 2`` as a child
   process (its worker, warm start and loader-in-the-loop run, each a process of its
   own) on a proxy tree of 16 + 16 480 x 960 images written to a temporary
   ``--data-root``: its last line parses, with ``compile_warm_s`` and
   ``e2e.data_time_share`` in [0, 1]; then each kernel against its plain version
   and timed at the worker's shapes (a 38 x 76 map, phases 2, 3 and 5's tolerances):
   K1 at (48, 512) and (16, 2000) ROIs, K2 at (48, 512), K3 at 48 and 16 x 12000 ->
   2000 and 16 x 16000 -> 100;
13. one JSON line of the kernels' launches (by path, the phases 9-12 paths
   included), error, time (CUDA events), bound and plain-version time. No kernel
   has one PyTorch call that computes the same function (core PyTorch has no
   ROIAlign, ROIAlign backward or NMS), so ``library_ms`` is null.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
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
# ROIAlign backward (label, images, ROIs per image): the fused student pass of a
# mutual step (2 x 16 labeled views + 16 unlabeled images) and of a burn-in step
# and the same passes per rank of a data-parallel step over 2 ranks (8 + 8 images each)
BWD_CASES = (("student", 48, 512), ("burnin", 32, 512), ("student_rank", 24, 512),
             ("burnin_rank", 16, 512))
# ROIAlign forward (label, images, ROIs per image) beside the inference shape: the
# student pass and the teacher pass of a mutual step, and the student pass per rank
# over 2 ranks (the teacher's per rank, 8 x 2000, is the inference shape)
FWD_STEP_CASES = (("student", 48, 512), ("teacher", 16, 2000), ("student_rank", 24, 512))
GT_PER_IMAGE = 20
# (label, images, K, max_keep, IoU threshold, classes): the RPN NMS of
# pseudo_labels and the class-aware NMS of its ROI inference at batch 8, then the
# three calls of one mutual step: the student's RPN (2 x 16 labeled views + 16
# unlabeled images), the teacher's RPN and the teacher's class-aware NMS; per rank
# over 2 ranks the student's RPN is 24 images (the teacher's two are the first two)
NMS_CASES = (("rpn", 8, 12000, 2000, 0.7, 0), ("class", 8, 16000, 100, 0.5, 8),
             ("rpn_student", 48, 12000, 2000, 0.7, 0), ("rpn_teacher", 16, 12000, 2000, 0.7, 0),
             ("class_teacher", 16, 16000, 100, 0.5, 8),
             ("rpn_student_rank", 24, 12000, 2000, 0.7, 0))
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
    main = time_k1("inference", feat32.to(torch.bfloat16), boxes, reps=20, plain_reps=3)
    del feat32
    cases = {label: fwd_check_and_time(dev, gen, label, n, r, FEAT)
             for label, n, r in FWD_STEP_CASES}
    return {"name": "roi_align_fwd", "route": "cuda",
            "source": "probabilisticteacher_torch/csrc/roi_align_fwd.cu",
            "replaces": "probabilisticteacher_tpu/ops/roi_align_pallas.py:70",
            "max_abs_err": result["bfloat16"], "max_abs_err_f32": result["float32"],
            **main, "library_ms": None, "cases": cases,
            "shape": "features (8, 38, 84, 512) bf16, boxes (8, 2000, 4) (ms, plain_ms, "
                     "bound_ms); the train step's shapes in cases"}


def fwd_check_and_time(dev, gen, label: str, n: int, r: int, feat_hwc) -> dict:
    """K1 in bf16 on (n, r) ROIs over an (n, *feat_hwc) map against its plain version
    (2e-2 * max|F|), then both timed."""
    h, w, c = feat_hwc
    boxes = roi_boxes(gen, n, r, h, w).to(dev)
    feat = torch.randn(n, h, w, c, generator=gen).to(dev, torch.bfloat16)
    got = roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2)
    want = roi_align_batched(feat, boxes, 1.0 / 16, 7, 2)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(err <= 2e-2 * feat.float().abs().max().item(),
          f"roi_align bf16 differs from its plain version ({label})")
    del got, want
    return {"rois": [n, r], "map": [h, w], "max_abs_err": err,
            **time_k1(label, feat, boxes, reps=10, plain_reps=1)}


def time_k1(label: str, feat: torch.Tensor, boxes: torch.Tensor, reps: int,
            plain_reps: int) -> dict:
    """K1's and its plain version's time on bf16 ``feat`` (N, H, W, C) and ``boxes``
    (N, R, 4), and the bound: the bytes of features, boxes and output against the
    f32 operations of 4 samples x 4 taps x (mul + add) and the mean per output."""
    n, r = boxes.shape[:2]
    c = feat.shape[-1]
    ms = cuda_ms(lambda: roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2), reps=reps)
    plain_ms = cuda_ms(lambda: roi_align_batched(feat, boxes, 1.0 / 16, 7, 2), reps=plain_reps,
                       warm=1)
    nbytes = feat.numel() * 2 + boxes.numel() * 4 + n * r * 49 * c * 2
    ops = n * r * 49 * c * 33
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[roi_align] {label} bf16 ({n}, {r}) ROIs: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({nbytes} B, {ops} f32 ops)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations"}


# --------------------------------------------------------------------- phase 3
def nms_case(gen: torch.Generator, n: int, k: int, canvas=CANVAS):
    """Clustered proposal-like boxes on an (h, w) ``canvas``, bf16-rounded scores (ties),
    duplicates, chains."""
    centers = torch.rand(n, k // 25 + 1, 2, generator=gen) * torch.tensor(
        [float(canvas[1]), float(canvas[0])])
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


def nms_check_and_time(dev, gen, label, n, k, max_keep, thresh, classes,
                       canvas=CANVAS) -> dict:
    """One NMS case: the kernel's keep set against the plain version's (exactly equal),
    then both timed and the bound from the IoU pairs this data needs."""
    boxes, scores, valid = (x.to(dev) for x in nms_case(gen, n, k, canvas))
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
    return {"images": n, "k": k, "max_keep": max_keep, "thresh": thresh,
            "kept": kept, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations"}


def phase_nms(dev) -> dict:
    gen = torch.Generator().manual_seed(2)
    out = {}
    for label, n, k, max_keep, thresh, classes in NMS_CASES:
        out[label] = nms_check_and_time(dev, gen, label, n, k, max_keep, thresh, classes)
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


def bwd_design_bytes(wy: torch.Tensor, wx: torch.Tensor, plan, bin_bytes: int) -> int:
    """g bytes the tiled backward reads beyond one read of each bin: a bin (q, x)
    is read by every tile that holds one of its taps (a row of Wy[q] and a column
    of Wx[x] with weights)."""
    n, r, p, h = wy.shape
    w = wx.shape[-1]

    def tiles(m, size, t, count):                  # (N, R, p) tiles the rows reach
        m = torch.nn.functional.pad(m != 0, (0, t * count - size))
        return m.reshape(n, r, p, count, t).any(-1).sum(-1)

    ny = tiles(wy, h, plan.th, plan.tiles_y)
    nx = tiles(wx, w, plan.tw, plan.tiles_x)
    reads = ny[..., :, None] * nx[..., None, :]   # (N, R, q, x)
    return int((reads - 1).clamp(min=0).sum()) * bin_bytes


def bwd_check_and_time(dev, label: str, n: int, r: int, feat_hwc) -> dict:
    """K2 on (n, r) ROIs into an (n, *feat_hwc) dF against its plain version in f32
    (1e-5 * max|dF|) and bf16 (2e-2 * max|dF|), bit-identical in two runs, then timed
    with its bound and ``design_bytes``."""
    h, w, c = feat_hwc
    gen = torch.Generator(device=dev).manual_seed(7)
    boxes = roi_boxes(torch.Generator().manual_seed(7), n, r, h, w).to(dev)
    g32 = torch.randn(n, r, 7, 7, c, generator=gen, device=dev)
    g32[:, r - 40:] = 0                # padded ROI rows: the masked losses give them 0
    err, rerun = {}, {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        g = g32.to(dtype)
        got = roi_align_cuda.roi_align_backward(g, boxes, (n, h, w, c), dtype, 1.0 / 16, 7, 2)
        again = roi_align_cuda.roi_align_backward(g, boxes, (n, h, w, c), dtype, 1.0 / 16, 7,
                                                  2)
        wy, wx = batched_pool_matrices(boxes, h, w, 1.0 / 16, 7, 2, dtype)
        want = roi_align_bwd_plain(wy, wx, g)
        torch.cuda.synchronize()
        name = str(dtype)[6:]
        scale = want.float().abs().max().item()
        err[name] = (got.float() - want.float()).abs().max().item()
        rerun[name] = (got.float() - again.float()).abs().max().item()
        log(f"[roi_align_bwd] {label} {name}: max|kernel - plain| = {err[name]!r} (limit "
            f"{tol} * max|dF| = {tol * scale!r}); two kernel runs differ by {rerun[name]!r}")
        check(got.shape == (n, h, w, c) and got.dtype == dtype, "roi_align_bwd output shape")
        check(bool(torch.isfinite(got).all()), "roi_align_bwd output not finite")
        check(err[name] <= tol * scale, f"roi_align_bwd {dtype} differs from its plain version")
        check(torch.equal(got, again), f"roi_align_bwd {dtype}: two runs differ ({label})")
        del got, again, want
    g = g32.to(torch.bfloat16)
    del g32
    wy, wx = batched_pool_matrices(boxes, h, w, 1.0 / 16, 7, 2, torch.bfloat16)
    ms = cuda_ms(lambda: roi_align_cuda.roi_align_backward(
        g, boxes, (n, h, w, c), torch.bfloat16, 1.0 / 16, 7, 2), reps=10)
    plain_ms = cuda_ms(lambda: roi_align_bwd_plain(wy, wx, g), reps=3, warm=1)
    taps = bwd_taps(wy, wx, g)
    # the function's bytes: g and the boxes read, dF written; the design reads
    # again the g of a bin whose taps reach more than one tile
    nbytes = g.numel() * 2 + boxes.numel() * 4 + n * h * w * c * 2
    plan = roi_align_cuda.bwd_plan(h, w, c, 7)
    design_bytes = bwd_design_bytes(wy, wx, plan, c * 2)
    ops = taps * c * 2                 # a multiply and an add per channel and tap
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    log(f"[roi_align_bwd] {label} bf16 ({n}, {r}) ROIs: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms ({nbytes} B, {taps} taps, {ops} f32 ops); "
        f"tiles {plan.tiles_y} x {plan.tiles_x} of {plan.th} x {plan.tw}, design_bytes "
        f"{design_bytes}")
    return {"rois": [n, r], "map": [h, w], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "design_bytes": design_bytes, "max_abs_err": err,
            "run_to_run_max_abs_diff": rerun,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations"}


def phase_roi_align_bwd(dev) -> dict:
    cases = {label: bwd_check_and_time(dev, label, n, r, FEAT) for label, n, r in BWD_CASES}
    st = cases[BWD_CASES[0][0]]
    return {"name": "roi_align_bwd", "route": "cuda",
            "source": "probabilisticteacher_torch/csrc/roi_align_bwd.cu",
            "replaces": "probabilisticteacher_tpu/ops/roi_align_pallas.py:228",
            "max_abs_err": st["max_abs_err"]["bfloat16"],
            "max_abs_err_f32": st["max_abs_err"]["float32"],
            "run_to_run_max_abs_diff": st["run_to_run_max_abs_diff"],
            "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "design_bytes": st["design_bytes"], "bound_by": st["bound_by"], "library_ms": None,
            "shape": "dOut (48, 512, 7, 7, 512) bf16 -> dF (48, 38, 84, 512), 40 zero rows "
                     "(ms, plain_ms, bound_ms); both train shapes in cases",
            "cases": cases}


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


# --------------------------------------------------------------------- phase 8
CLI_CONFIG = "configs/pt/final_c2f.yaml"
CLI_SPLITS = (("VOC2007_citytrain", "train", 32), ("VOC2007_foggytrain", "train", 32),
              ("VOC2007_foggyval", "val", 16))
CITYSCAPES_HW = (1024, 2048)
EVAL_TOL = 1e-6


def write_voc_split(root: str, name: str, split: str, count: int, seed: int) -> None:
    """A VOC tree of ``count`` Cityscapes-sized JPEGs under ``root/data/name`` (the
    layout ``register_builtin`` reads): a smooth random background and
    ``GT_PER_IMAGE`` bright boxes of the recipe's 8 classes per image."""
    import xml.etree.ElementTree as ET

    from PIL import Image

    from probabilisticteacher_torch.data.datasets import CLASS_NAMES_8

    base = os.path.join(root, "data", name)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = CITYSCAPES_HW
    ids = []
    for i in range(count):
        fid = f"{name}_{i:04d}"
        ids.append(fid)
        img = np.kron(rng.randint(0, 90, (h // 16, w // 16, 3)),
                      np.ones((16, 16, 1))).astype(np.uint8)
        root_el = ET.Element("annotation")
        size = ET.SubElement(root_el, "size")
        ET.SubElement(size, "width").text = str(w)
        ET.SubElement(size, "height").text = str(h)
        for _ in range(GT_PER_IMAGE):
            bw, bh = rng.randint(w // 80, w // 5), rng.randint(h // 40, h // 3)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(150, 256, 3)
            obj = ET.SubElement(root_el, "object")
            ET.SubElement(obj, "name").text = CLASS_NAMES_8[rng.randint(8)]
            ET.SubElement(obj, "difficult").text = "0"
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in (("xmin", x1 + 1), ("ymin", y1 + 1), ("xmax", x1 + bw),
                           ("ymax", y1 + bh)):
                ET.SubElement(bb, tag).text = str(v)
        Image.fromarray(img).save(os.path.join(base, "JPEGImages", fid + ".jpg"), quality=90)
        ET.ElementTree(root_el).write(os.path.join(base, "Annotations", fid + ".xml"))
    with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


class StepClock:
    """A trainer hook: host ms per iteration (each step ends in a synchronize, so
    the time is the step's on the card plus the wait for its batch) and the
    loader's ``data_time`` of the iteration."""

    def __init__(self):
        self.rows = []
        self.trainer = None
        self._t0 = 0.0

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def after_step(self):
        torch.cuda.synchronize()
        t = self.trainer
        phase = "burnin" if t.iter < t.burn_up else "mutual"
        self.rows.append({"iter": t.iter, "phase": phase,
                          "ms": (time.perf_counter() - self._t0) * 1e3,
                          "data_ms": t.last_data_time * 1e3})


def _finite_results(res: dict) -> bool:
    return "mAP50" in res and all(np.isfinite(v) for k, v in res.items()
                                  if k in ("mAP50", "bbox/AP50"))


def _same_results(a: dict, b: dict) -> float:
    check(a.keys() == b.keys(), f"metric keys differ: {sorted(a)} vs {sorted(b)}")
    return max(abs(a[k] - b[k]) for k in a)


def phase_cli(dev) -> tuple:
    """The port's CLI on the card (see the module docstring, phase 8), then the CLI's
    data-parallel launch on the same tree (phase 9 (b))."""
    import shutil
    import tempfile

    from probabilisticteacher_torch import checkpoint as ckpt
    from probabilisticteacher_torch import train_net
    from probabilisticteacher_torch.data import loader as data_loader
    from probabilisticteacher_torch.data import native
    from probabilisticteacher_torch.engine import trainer as trainer_mod

    work = tempfile.mkdtemp(prefix="pt_chip_smoke_")
    try:
        cli = _phase_cli(dev, work, ckpt, train_net, data_loader, native, trainer_mod)
        return cli, phase_dp_cli(dev, train_net, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_cli(dev, work, ckpt, train_net, data_loader, native, trainer_mod) -> dict:
    t0 = time.perf_counter()
    for i, (name, split, count) in enumerate(CLI_SPLITS):
        write_voc_split(work, name, split, count, seed=20 + i)
    os.environ["DETECTRON2_DATASETS"] = work
    decoder = "native" if native.available() else "PIL"
    log(f"[cli] wrote {sum(c for _, _, c in CLI_SPLITS)} {CITYSCAPES_HW[1]}x{CITYSCAPES_HW[0]} "
        f"JPEGs in {time.perf_counter() - t0!r} s; host decoder: {decoder}")
    if decoder != "native":
        log("[cli] the native loader did not build on this host (g++ with libjpeg and libpng "
            "headers is needed); the loader decodes with PIL")

    out_dir = os.path.join(work, "output")
    base = ["--config-file", CLI_CONFIG, "MODEL.VGG.PRETRAIN", "", "SEED", "0",
            "UNSUPNET.BURN_UP_STEP", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
            "TEST.EVAL_PERIOD", "4", "OUTPUT_DIR", out_dir]
    clock = StepClock()
    trainers = []
    evals = []
    orig_hooks = trainer_mod.PTrainer.build_hooks
    orig_resume = trainer_mod.PTrainer.resume_or_load
    orig_eval = trainer_mod.evaluate_detections

    def build_hooks(self):
        return orig_hooks(self) + [clock]

    def resume_or_load(self, resume=False):
        orig_resume(self, resume)
        trainers.append(self)
        # what was loaded, before any step moves it
        self.loaded = {"step": self.state.step,
                       "student": {k: v.clone() for k, v in self.state.student.state_dict().items()},
                       "teacher": {k: v.clone() for k, v in self.state.teacher.state_dict().items()},
                       "optimizer": copy.deepcopy(self.state.optimizer.state_dict())}

    def timed_eval(model, loader, *args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = orig_eval(model, loader, *args, **kwargs)
        torch.cuda.synchronize()
        evals.append({"images": len(loader), "s": time.perf_counter() - start})
        return res

    trainer_mod.PTrainer.build_hooks = build_hooks
    trainer_mod.PTrainer.resume_or_load = resume_or_load
    trainer_mod.evaluate_detections = timed_eval
    try:
        res1, c_train = drive_cli("cli_train", train_net, base + ["SOLVER.MAX_ITER", "4"])
        run1 = trainers[-1]
        rows1 = list(clock.rows)
        clock.rows.clear()
        check(run1.state.step == 4 and rows1[-1]["iter"] == 3, "the CLI did not run 4 steps")
        check([r["phase"] for r in rows1] == ["burnin"] * 2 + ["mutual"] * 2,
              "the CLI did not run 2 burn-in and 2 mutual steps")
        with open(os.path.join(out_dir, "metrics.json")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        written = sorted({r["iteration"] for r in recs})
        losses = {k: v for r in recs for k, v in r.items() if k.startswith(("loss", "total"))}
        log(f"[cli] metrics.json iterations {written}; last losses {json.dumps(losses)}")
        check(written == [0, 3], f"metrics.json holds iterations {written}, not [0, 3]")
        check(losses and all(np.isfinite(v) for v in losses.values()), "losses not finite")
        for it in (2, 4):
            check(os.path.isfile(os.path.join(out_dir, f"model_{it:07d}")),
                  f"no checkpoint at iteration {it}")
        check(ckpt.latest_checkpoint(out_dir) == os.path.join(out_dir, "model_0000004"),
              "last_checkpoint does not name model_0000004")
        log(f"[cli] final teacher eval {json.dumps(res1)}")
        check(_finite_results(res1), "the final eval gave no finite mAP")
        hook = run1.storage.latest()
        student4 = {k[:-len("_student")]: v for k, v in hook.items() if k.endswith("_student")}
        teacher4 = {k: hook[k] for k in res1}
        err_t = _same_results(teacher4, res1)
        log(f"[cli] EvalHook teacher at iteration 4 vs the final eval (same weights): "
            f"max |diff| {err_t!r}")
        check(err_t <= EVAL_TOL, "the final eval differs from the EvalHook's teacher eval")

        res2, c_resume = drive_cli("cli_resume", train_net,
                                   ["--resume"] + base + ["SOLVER.MAX_ITER", "6"])
        run2 = trainers[-1]
        saved = torch.load(os.path.join(out_dir, "model_0000004"), map_location="cpu",
                           weights_only=True)
        loaded = run2.loaded
        check(loaded["step"] == 4 and run2.start_iter == 4, "--resume did not start at 4")
        for part in ("student", "teacher"):
            check(all(torch.equal(v.cpu(), saved[part][k]) for k, v in loaded[part].items()),
                  f"the resumed {part} differs from the saved one")
        mom_saved, mom = saved["optimizer"]["state"], loaded["optimizer"]["state"]
        check(mom.keys() == mom_saved.keys() and len(mom) > 0 and all(
            torch.equal(mom[i]["trace"].cpu(), mom_saved[i]["trace"]) for i in mom),
            "the resumed momentum differs from the saved one")
        check(loaded["optimizer"]["count"] == saved["optimizer"]["count"] == 4,
              "the resumed optimizer count is not 4")
        rows2 = list(clock.rows)
        check(run2.state.step == 6 and [r["iter"] for r in rows2] == [4, 5]
              and all(r["phase"] == "mutual" for r in rows2),
              "the resumed run did not take mutual steps 4 and 5")
        check(_finite_results(res2), "the resumed run's eval gave no finite mAP")
        log("[cli] --resume: step 4, teacher, student and momentum equal the saved ones bit "
            f"for bit; steps 4-5 ran; eval {json.dumps(res2)}")

        eval_dir = os.path.join(work, "eval_only")
        res3, c_eval = drive_cli("cli_eval_only", train_net, [
            "--config-file", CLI_CONFIG, "--eval-only", "MODEL.VGG.PRETRAIN", "",
            "MODEL.WEIGHTS", os.path.join(out_dir, "model_0000004"), "OUTPUT_DIR", eval_dir],
            required=INFERENCE_KERNELS)
        err_s = _same_results(res3, student4)
        log(f"[cli] --eval-only of model_0000004 (the student, as the root train_net.py) "
            f"vs the EvalHook's student eval at iteration 4: max |diff| {err_s!r}")
        check(err_s <= EVAL_TOL, "--eval-only differs from the trainer's eval of the same weights")
    finally:
        trainer_mod.PTrainer.build_hooks = orig_hooks
        trainer_mod.PTrainer.resume_or_load = orig_resume
        trainer_mod.evaluate_detections = orig_eval

    # Predictor on one val image against detect on that image's canvas
    cfg = run2.cfg
    pred = Predictor(cfg, checkpoint_path=os.path.join(out_dir, "model_0000006"), device=dev)
    from probabilisticteacher_torch.data.datasets import DatasetCatalog

    rec = DatasetCatalog.get("VOC2007_foggyval")[0]
    pil_cfg = cfg.clone()   # the Predictor decodes and resizes with PIL: so does this canvas
    pil_cfg.defrost()
    pil_cfg.DATALOADER.NATIVE = False
    mapped = data_loader.Mapper(pil_cfg, is_train=False)(rec, np.random.default_rng(0))
    canvas = ImageBatch(torch.from_numpy(mapped["image"][None]).to(dev),
                        torch.from_numpy(mapped["image_hw"][None]).to(dev))
    with torch.inference_mode():
        dets = run2.state.teacher.detect(canvas)
    v = dets.valid[0].cpu().numpy()
    want_boxes = dets.boxes[0].cpu().numpy()[v] / float(mapped["scale"])
    got = pred(data_loader.read_image(rec["file_name"], cfg.INPUT.FORMAT))
    check(len(got["boxes"]) == len(want_boxes) > 0, "Predictor and detect keep different counts")
    box_err = float(np.abs(got["boxes"] - want_boxes).max())
    log(f"[cli] Predictor(checkpoint_path=model_0000006) vs the teacher's detect on the "
        f"image's canvas: {len(want_boxes)} boxes, max |diff| {box_err!r}")
    check(box_err <= 1e-4 and np.array_equal(got["classes"], dets.classes[0].cpu().numpy()[v]),
          "Predictor differs from detect on the same image")

    steady = rows1[1:] + rows2
    data_share = sum(r["data_ms"] for r in steady) / sum(r["ms"] for r in steady)
    eval_ips = [e["images"] / e["s"] for e in evals]
    out = {"decoder": decoder, "steps": rows1 + rows2, "data_wait_share": data_share,
           "eval": evals, "eval_img_per_s": eval_ips, "final_eval": res1,
           "resumed_eval": res2, "eval_only": res3}
    log(f"[cli] ms per iteration with the loader in the loop (host clock, each step "
        f"synchronized): {json.dumps(rows1 + rows2)}")
    log(f"[cli] share of the step waiting on data (iterations 1-5): {data_share!r}; eval "
        f"images/s {eval_ips!r} (batch {cfg.TEST.IMS_PER_BATCH}); {card_line()}")
    return {"out": out, "launches": {"cli_train": c_train, "cli_resume": c_resume,
                                     "cli_eval_only": c_eval},
            "calls": {"cli_train": 1, "cli_resume": 1, "cli_eval_only": 1}}


def drive_cli(name: str, train_net, argv, required=KERNELS):
    """Run ``train_net.main`` once with the launch counts zeroed just before."""
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = train_net.main(train_net.parse_args(argv))
    counts = {k.symbol: k.launches for k in KERNELS}
    log(f"[path] {name}: {time.perf_counter() - t0!r} s; launches {counts}")
    for k in required:
        check(counts[k.symbol] > 0, f"{k.symbol} was not launched on the {name} path")
    return res, counts


# --------------------------------------------------------------------- phase 9
DP_WORLD = 2
DP_TIMEOUT_S = 420
DP_BF16_STEPS = 3


def dp_cfg(amp: bool, burn_up: int):
    """The recipe at full width (16 + 16 images, 608 x 1344), with proposals under
    2 px dropped as in phase 7."""
    cfg = train_cfg()
    cfg.merge_from_list(["SOLVER.AMP.ENABLED", str(amp), "UNSUPNET.BURN_UP_STEP", str(burn_up),
                         "MODEL.PROPOSAL_GENERATOR.MIN_SIZE", "2.0"])
    return cfg


def dp_student(cfg, dev):
    """Seeded weights, with class and objectness weights scaled up as in phase 7."""
    student = PTDetector(Arch.from_cfg(cfg), device=dev)
    student.init(seed=0)
    with torch.no_grad():
        student.predictor.cls_score.weight.mul_(4)
        student.rpn_head.objectness.weight.mul_(10)
    return student


def dp_batches(dev):
    gen = torch.Generator().manual_seed(8)
    limg, lgt = train_batch(gen, TRAIN_N, dev, labeled=True)
    return limg, lgt, train_batch(gen, TRAIN_N, dev, labeled=False)


def dp_f32_steps(dev, mesh) -> dict:
    """In f32 with TF32 off, a ``burnin_step`` and, from the same seeded weights, a
    ``mutual_step`` (the boundary copy), over the global batch (a world of one) or
    this rank's share of it: the metrics summed over the ranks and every parameter's
    summed gradient of each step.

    Each step starts from the seeded weights, not the mutual step from the burn-in
    step's update: two runs whose gradients were summed in another order hold
    weights that differ in their last bits, and at random weights a teacher whose
    boxes move by an ulp flips ties among the RPN matcher's best anchors, which
    moves the unsupervised RPN loss by percents.
    """
    from probabilisticteacher_torch.parallel.mesh import all_reduce_sum, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    limg, lgt, uimg = shard_batch(mesh, dp_batches(dev))
    stage = "grad_all_reduce" if mesh.distributed else "backward"
    out = {"metrics": [], "grads": [], "launches": []}
    for burn_up in (1, 0):                    # step 0: burn-in, then mutual (the boundary)
        cfg = dp_cfg(False, burn_up)
        student = dp_student(cfg, dev)
        state = create_train_state(student, build_optimizer(cfg, student))
        burnin, mutual = make_train_steps(cfg, student, mesh)
        draws = torch.Generator(device=dev).manual_seed(9)

        def mark(name):
            if name == stage:
                out["grads"].append({k: p.grad.detach().float().cpu() for k, p in
                                     state.student.named_parameters() if p.grad is not None})

        for k in KERNELS:
            k.launches = 0
        if burn_up:
            state, m = burnin(state, limg, lgt, draws, mark)
        else:
            state, m = mutual(state, limg, lgt, uimg, draws, mark)
        out["launches"].append({k.symbol: k.launches for k in KERNELS})
        names = sorted(m)
        total = all_reduce_sum(mesh, torch.stack([m[k].float() for k in names]))
        out["metrics"].append(dict(zip(names, total.tolist())))
        del state, student
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def dp_bf16_steps(dev, mesh) -> dict:
    """``DP_BF16_STEPS`` mutual steps in bf16 on this rank's share: metrics finite,
    the replicas bit-identical after each step (rank 0's parameters broadcast and
    compared), host ms per step and of the gradient all-reduce."""
    import torch.distributed as dist

    from probabilisticteacher_torch.parallel.mesh import shard_batch

    cfg = dp_cfg(True, 0)
    student = dp_student(cfg, dev)
    state = create_train_state(student, build_optimizer(cfg, student))
    _, mutual = make_train_steps(cfg, student, mesh)
    limg, lgt, uimg = shard_batch(mesh, dp_batches(dev))
    draws = torch.Generator(device=dev).manual_seed(9)
    t_red = {}

    def mark(name):
        if name in ("backward", "grad_all_reduce"):
            torch.cuda.synchronize()
            t_red[name] = time.perf_counter()

    step_ms, reduce_ms, identical, finite = [], [], [], []
    for k in KERNELS:
        k.launches = 0
    for _ in range(DP_BF16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = mutual(state, limg, lgt, uimg, draws, mark)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        reduce_ms.append((t_red["grad_all_reduce"] - t_red["backward"]) * 1e3)
        finite.append(_finite(m))
        flat = torch.cat([p.detach().reshape(-1).float() for p in state.student.parameters()])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=mesh.group)
        identical.append(bool(torch.equal(flat, ref)))
    counts = {k.symbol: k.launches for k in KERNELS}
    del state, student
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "grad_all_reduce_ms": reduce_ms, "identical": identical,
            "finite": finite, "launches": counts}


def dp_device(rank: int, shared_card: bool) -> torch.device:
    return torch.device("cuda", 0 if shared_card else rank)


def dp_rank(rank: int, port: int, backend: str, shared_card: bool, out_dir: str) -> None:
    """One spawned rank: joins the group, runs the f32 equivalence steps and (on a
    shared card) the bf16 steps, and writes what it saw (rank 0: with the gradients)."""
    from probabilisticteacher_torch.parallel.mesh import make_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = dp_device(rank, shared_card)
    mesh = make_mesh(dev, backend=backend)
    out = {"world": mesh.world_size, "backend": mesh.backend, "device": str(mesh.device),
           "f32": dp_f32_steps(dev, mesh)}
    if rank != 0:
        out["f32"].pop("grads")
    if shared_card:
        out["bf16"] = dp_bf16_steps(dev, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_dp_ranks(backend: str, shared_card: bool) -> list:
    """Spawn the ranks (``spawn``: this process has initialized CUDA), join each with
    a time limit, and kill them all if one fails or hangs."""
    import multiprocessing as mp
    import shutil
    import socket
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="pt_chip_dp_")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, port, backend, shared_card, out_dir))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + DP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1))
        codes = [p.exitcode for p in procs]
        check(all(c == 0 for c in codes), f"data-parallel ranks ended with {codes} "
                                           f"(None: still running after {DP_TIMEOUT_S} s)")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_WORLD)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)


def dp_compare(label: str, ref: dict, ranks: list) -> dict:
    """The ranks' f32 steps against one process over the global batch: metrics within
    ``TRAIN_REF_LOSS_TOL`` relative, each summed gradient within ``TRAIN_REF_GRAD_TOL``
    of its L2 norm (phase 7's limits)."""
    got = ranks[0]["f32"]
    check(all(r["f32"]["metrics"] == got["metrics"] for r in ranks),
          f"{label}: the ranks' summed metrics differ")
    loss_err, grad_err, worst = 0.0, 0.0, None
    for step, (w, g) in enumerate(zip(ref["metrics"], got["metrics"])):
        check(w.keys() == g.keys(), f"{label}: metric names differ")
        loss_err = max([loss_err] + [abs(g[k] - v) / max(abs(v), 1e-6) for k, v in w.items()])
        # the all-reduce gives a parameter with no gradient (anchor_wh in burn-in) a zero one
        extra = got["grads"][step].keys() - ref["grads"][step].keys()
        check(ref["grads"][step].keys() <= got["grads"][step].keys()
              and all(not got["grads"][step][k].any() for k in extra),
              f"{label}: gradients of different parameters")
        for k, v in ref["grads"][step].items():
            e = ((got["grads"][step][k] - v).norm() / v.norm().clamp(min=1e-30)).item()
            if e > grad_err:
                grad_err, worst = e, f"step {step} {k}"
    log(f"[dp] {label}: {len(ranks)} ranks ({ranks[0]['backend']}, {ranks[0]['device']}, "
        f"{ranks[1]['device']}) vs one process over the global batch, f32: max relative "
        f"metric error {loss_err!r} (limit {TRAIN_REF_LOSS_TOL}); worst gradient error "
        f"{grad_err!r} of its L2 norm ({worst}; limit {TRAIN_REF_GRAD_TOL})")
    log(f"[dp] {label}: metrics after the mutual step {json.dumps(got['metrics'][-1])}")
    check(loss_err <= TRAIN_REF_LOSS_TOL, f"{label}: metrics differ from one process")
    check(grad_err <= TRAIN_REF_GRAD_TOL, f"{label}: gradients differ from one process")
    return {"loss_err": loss_err, "grad_err": grad_err, "worst": worst}


def phase_dp(dev) -> dict:
    """Data parallel (see the module docstring, phase 9 (a))."""
    from probabilisticteacher_torch.parallel.mesh import Mesh

    ref = dp_f32_steps(dev, Mesh(0, 1, dev))
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = run_dp_ranks("gloo", shared_card=True)
    out = {"runs": [{"world": r["world"], "backend": r["backend"], "device": r["device"]}
                    for r in ranks]}
    out["shared_card_gloo"] = dp_compare("2 ranks sharing the card", ref, ranks)
    for r, rank in enumerate(ranks):
        b = rank["bf16"]
        log(f"[dp] rank {r} bf16 mutual steps (8 + 8 images): ms per step {b['step_ms']!r}; "
            f"gradient all-reduce ms {b['grad_all_reduce_ms']!r}; replicas bit-identical "
            f"{b['identical']}; launches {b['launches']}")
        check(all(b["finite"]), f"rank {r}: bf16 metrics not finite")
        check(all(b["identical"]), f"rank {r}: the replicas differ after a bf16 step")
        for k in KERNELS:
            check(b["launches"][k.symbol] > 0, f"{k.symbol} was not launched on rank {r}")
    log("[dp] the two ranks share one card, each running while the other waits or runs: "
        "their step time is no scaling figure")
    out["bf16"] = [rank["bf16"] for rank in ranks]
    launches = {}
    for r, rank in enumerate(ranks):
        launches[f"dp_burnin_step_rank{r}"] = rank["f32"]["launches"][0]
        launches[f"dp_mutual_step_rank{r}"] = rank["f32"]["launches"][1]
        launches[f"dp_mutual_step_bf16_rank{r}"] = rank["bf16"]["launches"]
    for name, c in launches.items():
        for k in KERNELS:
            check(c[k.symbol] > 0, f"{k.symbol} was not launched on the {name} path")
    if torch.cuda.device_count() >= DP_WORLD:
        nccl = run_dp_ranks("nccl", shared_card=False)
        out["runs"] += [{"world": r["world"], "backend": r["backend"], "device": r["device"]}
                        for r in nccl]
        out["two_cards_nccl"] = dp_compare("2 ranks on 2 cards", ref, nccl)
    else:
        log(f"[dp] {torch.cuda.device_count()} card: NCCL across cards is not run here")
    log(f"[dp] world sizes and backends run: {json.dumps(out['runs'])}")
    return {"out": out, "launches": launches, "calls": {k: 1 for k in launches}}


def phase_dp_cli(dev, train_net, work) -> dict:
    """The CLI with ``--num-gpus <cards>`` over NCCL on the tree phase 8 wrote: a world
    of one on a one-card machine (``train_net.main`` runs it in this process)."""
    cards = torch.cuda.device_count()
    argv = ["--num-gpus", str(cards), "--config-file", CLI_CONFIG, "MODEL.VGG.PRETRAIN", "",
            "SEED", "0", "UNSUPNET.BURN_UP_STEP", "1", "SOLVER.CHECKPOINT_PERIOD", "0",
            "TEST.EVAL_PERIOD", "0", "SOLVER.MAX_ITER", "2",
            "OUTPUT_DIR", os.path.join(work, "output_dp")]
    if cards == 1:
        res, counts = drive_cli("cli_num_gpus", train_net, argv)
    else:
        res, counts = train_net.main(train_net.parse_args(argv)), None
    log(f"[dp] CLI --num-gpus {cards}: {json.dumps(res)}")
    check(_finite_results(res), "the --num-gpus run gave no finite mAP")
    check(os.path.isfile(os.path.join(work, "output_dp", "model_0000002")),
          "the --num-gpus run wrote no checkpoint")
    return {"out": {"num_gpus": cards, "eval": res},
            "launches": {} if counts is None else {"cli_num_gpus": counts},
            "calls": {} if counts is None else {"cli_num_gpus": 1}}


# --------------------------------------------------------------------- phase 10
NMS_IMPLS = ("greedy", "maxpool", "maxpool_train", "hybrid")


def lever_proposals(name, det, feat, batch, impl, training) -> dict:
    """``predict_proposals`` alone under the lever: valid, finite boxes inside each
    image, and K3 launched exactly where the lever runs the exact NMS."""
    obj, deltas = det.rpn_predict(feat)
    anchors = det.anchors(feat.shape[1], feat.shape[2])
    exact = impl in ("greedy", "hybrid") or (impl == "maxpool_train" and not training)
    props, times, counts = drive(name, lambda: det.predict_proposals(
        anchors, obj, deltas, batch.image_hw, training, grid_hw=tuple(feat.shape[1:3])), 2,
        required=(nms_cuda.KERNEL,) if exact else ())
    check((counts[nms_cuda.KERNEL.symbol] > 0) == exact,
          f"{name}: the NMS kernel launched {counts[nms_cuda.KERNEL.symbol]} times")
    v = props.valid
    b = props.boxes[v]
    hw = batch.image_hw[:, None, :].expand(-1, v.shape[1], -1)[v]
    check(bool(v.any(dim=1).all()), f"{name}: an image has no valid proposal")
    check(bool(torch.isfinite(b).all() and torch.isfinite(props.logits[v]).all()),
          f"{name}: proposals not finite")
    check(bool((b[:, 0] >= 0).all() and (b[:, 1] >= 0).all() and (b[:, 2] <= hw[:, 1]).all()
               and (b[:, 3] <= hw[:, 0]).all() and (b[:, 2] > b[:, 0]).all()
               and (b[:, 3] > b[:, 1]).all()), f"{name}: proposals outside their image")
    return {"ms": times, "valid_per_image": (v.sum() / v.shape[0]).item(), "launches": counts}


def phase_levers(dev) -> dict:
    """The opt-in levers at full width (see the module docstring, phase 10)."""
    from probabilisticteacher_torch.profile_slice import KERNEL_ROWS, kernel_ms, profile_call

    gen = torch.Generator().manual_seed(11)
    image = (torch.rand(N, *CANVAS, 3, generator=gen) * 255).to(dev)
    hw = torch.tensor(IMAGE_HW[:N], dtype=torch.float32, device=dev)
    inside = ((torch.arange(CANVAS[0], device=dev)[None, :, None] < hw[:, 0, None, None])
              & (torch.arange(CANVAS[1], device=dev)[None, None, :] < hw[:, 1, None, None]))
    batch = ImageBatch(image * inside[..., None], hw)
    limg, lgt, uimg = dp_batches(dev)
    out, launches, calls = {}, {}, {}
    k3 = KERNEL_ROWS["nms_keep_ms"]
    for impl in NMS_IMPLS:
        cfg = dp_cfg(True, 0)
        cfg.merge_from_list(["MODEL.RPN.NMS_IMPL", impl])
        det = dp_student(cfg, dev)
        row = {}
        with torch.no_grad():
            feat = det.features(batch)
            for training in (False, True):
                name = f"proposals_{impl}_{'train' if training else 'test'}"
                row[name] = lever_proposals(name, det, feat, batch, impl, training)
                launches[name], calls[name] = row[name].pop("launches"), 2
        del feat
        for path, fn in (("detect", det.detect), ("pseudo_labels", det.pseudo_labels)):
            name = f"{path}_{impl}"
            res, t, c = drive(name, lambda: fn(batch), 2)
            check_outputs(name, res, N, det.arch.detections_per_image, det.arch.num_classes)
            prof, rows = profile_call(lambda: fn(batch))
            row[name] = {"ms": t, "k3_ms": kernel_ms(rows, k3)}
            launches[name], calls[name] = c, 2
        state = create_train_state(det, build_optimizer(cfg, det))
        _, mutual = make_train_steps(cfg, det)
        draws = torch.Generator(device=dev).manual_seed(12)
        name = f"mutual_step_{impl}"
        (state, m), t, c = drive(name, lambda: mutual(state, limg, lgt, uimg, draws), 1, KERNELS)
        check(_finite(m), f"{name}: metrics not finite {m}")
        check(float(m["num_pseudo_boxes"]) > 0, f"{name}: the teacher made no pseudo-labels")
        prof, rows = profile_call(lambda: mutual(state, limg, lgt, uimg, draws))
        row[name] = {"ms": t, "k3_ms": kernel_ms(rows, k3),
                     "num_valid_proposals": {k: float(v) for k, v in m.items()
                                             if k.startswith("rpn/num_valid_proposals")}}
        launches[name], calls[name] = c, 1
        log(f"[levers] {impl}: {json.dumps(row)}")
        out[impl] = row
        del state, det
        torch.cuda.empty_cache()
    out["remat"], launches_r = phase_remat(dev, limg, lgt, uimg)
    launches.update(launches_r)
    calls.update({k: 1 for k in launches_r})
    return {"out": out, "launches": launches, "calls": calls}


def phase_remat(dev, limg, lgt, uimg):
    """One bf16 mutual step with ``MODEL.BACKBONE.REMAT`` off and on from the same
    state and draws: gradients within ``TRAIN_REF_GRAD_TOL`` of their L2 norm, a
    lower peak memory with REMAT on, and the ms of both."""
    runs, launches = {}, {}
    for remat in (False, True):
        cfg = dp_cfg(True, 0)
        cfg.merge_from_list(["MODEL.BACKBONE.REMAT", str(remat)])
        det = dp_student(cfg, dev)
        state = create_train_state(det, build_optimizer(cfg, det))
        _, mutual = make_train_steps(cfg, det)
        grads, stages = {}, []

        def mark(name):
            # each stage's peak, and what stays allocated after it
            stages.append((name, torch.cuda.max_memory_allocated() / 2**30,
                           torch.cuda.memory_allocated() / 2**30))
            torch.cuda.reset_peak_memory_stats()
            if name == "backward":
                grads.update({k: p.grad.detach().float().cpu() for k, p in
                              state.student.named_parameters() if p.grad is not None})

        draws = torch.Generator(device=dev).manual_seed(13)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        name = f"mutual_step_remat_{'on' if remat else 'off'}"
        (state, m), t, c = drive(name, lambda: mutual(state, limg, lgt, uimg, draws, mark), 1,
                                 KERNELS)
        check(_finite(m), f"{name}: metrics not finite")
        runs[remat] = {"ms": t, "peak_gib": max(p for _, p, _ in stages), "grads": grads,
                       "stages_gib": stages}
        log(f"[levers] {name}: (stage, peak GiB, allocated GiB after it) {stages!r}")
        launches[name] = c
        del state, det
    off, on = runs[False], runs[True]
    err, worst = 0.0, None
    for k, v in off["grads"].items():
        e = ((on["grads"][k] - v).norm() / v.norm().clamp(min=1e-30)).item()
        if e > err:
            err, worst = e, k
    log(f"[levers] REMAT: mutual step ms off {off['ms']!r}, on {on['ms']!r}; peak GiB off "
        f"{off['peak_gib']!r}, on {on['peak_gib']!r}; worst gradient error {err!r} of its L2 "
        f"norm ({worst}; limit {TRAIN_REF_GRAD_TOL})")
    check(on["grads"].keys() == off["grads"].keys(), "REMAT changes which parameters get a gradient")
    check(err <= TRAIN_REF_GRAD_TOL, "REMAT changes the gradients")
    check(on["peak_gib"] < off["peak_gib"], "REMAT does not lower the peak memory")
    torch.cuda.empty_cache()
    return ({"ms_off": off["ms"], "ms_on": on["ms"], "peak_gib_off": off["peak_gib"],
             "peak_gib_on": on["peak_gib"], "stages_gib_off": off["stages_gib"],
             "stages_gib_on": on["stages_gib"], "grad_err": err}, launches)


# --------------------------------------------------------------------- phase 11
# the accuracy proxy's campaign at a small depth: make_daod_proxy.py's 480 x 960
# images, 32 + 32 to train on and 8 + 8 to evaluate; 20 source-only iterations, then
# 20 PT iterations (BURN_UP_STEP 10) from stage 1's final checkpoint, evals every 10
PROXY_ARGS = ("--iters", "20", "--burn", "10", "--eval-period", "10", "--n-train", "32",
              "--n-val", "8")
PROXY_CANVAS = (480, 992)
PROXY_FEAT = (30, 62, 512)          # the proxy's canvas over stride 16
# the kernels at the proxy's shapes: K1 in the student and teacher passes, K2 in the
# mutual and burn-in backward, K3 in the student's and teacher's RPN and the teacher's
# class-aware NMS
PROXY_FWD = (("proxy_student", 48, 512), ("proxy_teacher", 16, 2000))
PROXY_BWD = (("proxy_student", 48, 512), ("proxy_burnin", 32, 512))
PROXY_NMS = (("proxy_rpn_student", 48, 12000, 2000, 0.7, 0),
             ("proxy_rpn_teacher", 16, 12000, 2000, 0.7, 0),
             ("proxy_class_teacher", 16, 16000, 100, 0.5, 8))


class BoundaryProbe:
    """A trainer hook: the student before step ``BURN_UP_STEP`` and the teacher after
    it, which the boundary copy makes equal."""

    def __init__(self):
        self.trainer = None
        self.student = self.teacher = None

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        t = self.trainer
        if t.iter == t.burn_up:
            self.student = {k: v.clone() for k, v in t.state.student.state_dict().items()}

    def after_step(self):
        t = self.trainer
        if t.iter == t.burn_up:
            self.teacher = {k: v.clone() for k, v in t.state.teacher.state_dict().items()}


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def phase_proxy(dev) -> dict:
    """The accuracy-proxy runner's campaign at a small depth, each stage's
    ``train_net.main`` in this process (see the module docstring, phase 11)."""
    import shutil
    import tempfile

    from probabilisticteacher_torch import accuracy_proxy, train_net
    from probabilisticteacher_torch.data.datasets import CLASS_NAMES_8, register_pascal_voc
    from probabilisticteacher_torch.engine import trainer as trainer_mod

    work = tempfile.mkdtemp(prefix="pt_chip_proxy_")
    orig_hooks = trainer_mod.PTrainer.build_hooks
    orig_resume = trainer_mod.PTrainer.resume_or_load
    try:
        args = accuracy_proxy.build_parser(campaign=True).parse_args(list(PROXY_ARGS) + [
            "--data", os.path.join(work, "data"), "--out-root", os.path.join(work, "runs"),
            "--archive", os.path.join(work, "archive")])
        t0 = time.perf_counter()
        accuracy_proxy.ensure_data(args)
        log(f"[proxy] make_daod_proxy.py wrote {2 * args.n_train} + {2 * args.n_val} "
            f"{args.hw[1]}x{args.hw[0]} images in {time.perf_counter() - t0!r} s")
        # phase 8 registered the builtin names on its own tree: point them at the proxy
        for name in accuracy_proxy.PROXY_SPLITS:
            register_pascal_voc(name, os.path.join(args.data, "data", name),
                                "val" if name.endswith("val") else "train", CLASS_NAMES_8)
        probe, trainers, launches = BoundaryProbe(), [], {}

        def build_hooks(self):
            return orig_hooks(self) + [probe]

        def resume_or_load(self, resume=False):
            orig_resume(self, resume)
            trainers.append(self)
            self.loaded = {part: {k: v.clone() for k, v in
                                  getattr(self.state, part).state_dict().items()}
                           for part in ("student", "teacher")}

        def launch(argv, env, log_path, append):
            os.environ["DETECTRON2_DATASETS"] = env["DETECTRON2_DATASETS"]
            name = f"proxy_stage{len(launches) + 1}"
            launches[name] = drive_cli(name, train_net, argv)[1]
            return 0

        trainer_mod.PTrainer.build_hooks = build_hooks
        trainer_mod.PTrainer.resume_or_load = resume_or_load
        torch.cuda.reset_peak_memory_stats()
        result = accuracy_proxy.campaign(args, launch=launch)

        s1 = accuracy_proxy.stage_args(args, 1)
        s2 = accuracy_proxy.stage_args(args, 2, s1.out)
        for ns, keys in ((s1, (accuracy_proxy.FOGGY_STUDENT, accuracy_proxy.CITY_STUDENT)),
                         (s2, ("mAP50", "mAP50_student", "num_pseudo_boxes"))):
            recs = accuracy_proxy.read_records(ns.out)
            losses = [v for r in recs for k, v in r.items() if k.startswith(("loss", "total"))]
            check(losses and all(np.isfinite(v) for v in losses),
                  f"{os.path.basename(ns.out)}: losses not finite")
            ev = accuracy_proxy.evals(ns.out)
            check(bool(ev) and all(k in r and np.isfinite(r[k]) for _, r in ev for k in keys),
                  f"{os.path.basename(ns.out)}: eval metrics {keys} missing or not finite")
            log(f"[proxy] {os.path.basename(ns.out)}: evals "
                f"{json.dumps([(e, {k: r[k] for k in keys}) for e, r in ev])}")
        final1 = torch.load(os.path.join(s1.out, f"model_{args.iters:07d}"), map_location="cpu",
                            weights_only=True)
        stage2 = trainers[-1]
        check(len(trainers) == 2 and stage2.cfg.MODEL.WEIGHTS == s2.weights
              and stage2.burn_up == args.burn, "stage 2 did not start from stage 1's checkpoint")
        for part in ("student", "teacher"):
            check(_same_state(stage2.loaded[part], final1[part]),
                  f"MODEL.WEIGHTS: stage 2's {part} differs from stage 1's final {part}")
        check(probe.student is not None and probe.teacher is not None
              and _same_state(probe.teacher, probe.student),
              "the teacher after step BURN_UP_STEP is not the student before it")
        log(f"[proxy] MODEL.WEIGHTS: stage 2 starts from stage 1's model_{args.iters:07d}, "
            f"student and teacher bit for bit; the teacher after step {args.burn} equals the "
            f"student before it bit for bit; {card_line()}")
        stages = {k: v["stats"] for k, v in result["stages"].items()}
    finally:
        trainer_mod.PTrainer.build_hooks = orig_hooks
        trainer_mod.PTrainer.resume_or_load = orig_resume
        shutil.rmtree(work, ignore_errors=True)

    gen = torch.Generator().manual_seed(11)
    cases = {
        "roi_align_fwd": {label: fwd_check_and_time(dev, gen, label, n, r, PROXY_FEAT)
                          for label, n, r in PROXY_FWD},
        "roi_align_bwd": {label: bwd_check_and_time(dev, label, n, r, PROXY_FEAT)
                          for label, n, r in PROXY_BWD},
        "nms_keep": {label: nms_check_and_time(dev, gen, label, *case, canvas=PROXY_CANVAS)
                     for label, *case in PROXY_NMS},
    }
    return {"out": {"stages": stages, "bands": result["bands"]}, "launches": launches,
            "calls": {name: 1 for name in launches}, "cases": cases}


# --------------------------------------------------------------------- phase 12
BENCH_WORKER_ARGS = ("--worker", "--batch", "16", "--iters", "3", "--windows", "3",
                     "--window-budget-s", "20")
BENCH_CHILD_ARGS = ("--iters", "4", "--windows", "2", "--attempt-timeout-s", "300")
BENCH_PROXY = ("--n-train", "16", "--n-val", "1", "--hw", "480", "960")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline", "windows", "window_min",
              "window_max", "spread", "compile_s", "batch", "device", "images_rule", "step_ms",
              "conv_tflop_per_iter", "conv_mfu")
BENCH_CANVAS = (608, 1216)
BENCH_FEAT = (38, 76, 512)          # the bench's canvas over stride 16
# the kernels at the bench worker's shapes (--batch 16): K1 in the student and teacher
# passes, K2 in the student backward, K3 in the student's and teacher's RPN and the
# teacher's class-aware NMS
BENCH_FWD = (("bench_student", 48, 512), ("bench_teacher", 16, 2000))
BENCH_BWD = (("bench_student", 48, 512),)
BENCH_NMS = (("bench_rpn_student", 48, 12000, 2000, 0.7, 0),
             ("bench_rpn_teacher", 16, 12000, 2000, 0.7, 0),
             ("bench_class_teacher", 16, 16000, 100, 0.5, 8))


def phase_bench(dev) -> dict:
    """The bench entry (see the module docstring, phase 12)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from probabilisticteacher_torch import bench

    args = bench.build_parser().parse_args(list(BENCH_WORKER_ARGS))
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = bench.run_worker(args)
    worker_s = time.perf_counter() - t0
    counts = {k.symbol: k.launches for k in KERNELS}
    log(f"[bench] worker record {buf.getvalue().strip()}")
    log(f"[path] bench_worker: {worker_s!r} s; launches {counts}")
    for k in KERNELS:
        check(counts[k.symbol] > 0, f"{k.symbol} was not launched on the bench_worker path")
    missing = [k for k in BENCH_KEYS if k not in rec]
    check(not missing, f"bench record lacks {missing}")
    check(np.isfinite(rec["value"]) and rec["value"] > 0, f"bench value {rec['value']}")
    check(abs(rec["value"] - 4 * 16 / rec["step_ms"] * 1e3) <= 0.01,
          f"bench value {rec['value']} is not 4 x 16 / step_ms {rec['step_ms']}")
    check(rec["conv_mfu"] is not None and 0 < rec["conv_mfu"] <= 1,
          f"conv_mfu {rec['conv_mfu']}")
    calls = bench.WARMUP_STEPS + args.iters * len(rec["windows"])

    work = tempfile.mkdtemp(prefix="pt_chip_bench_")
    try:
        root = os.path.join(work, "proxy")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, bench.MAKE_PROXY, "--root", root, *BENCH_PROXY],
                       check=True, capture_output=True, timeout=300)
        proxy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "probabilisticteacher_torch.bench",
                                 *BENCH_CHILD_ARGS, "--data-root", root],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.terminate()          # the entry kills its own children on SIGTERM
            proc.communicate()
            check(False, "python -m probabilisticteacher_torch.bench ran past 900 s")
        child_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for line in stderr.splitlines():
        if line.startswith(("[bench] built", "[bench] e2e:", "[bench] warm start")):
            log(line)
    check(proc.returncode == 0, f"bench exited {proc.returncode}: {stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    check(len(lines) == 1, f"bench printed {len(lines)} lines")
    full = json.loads(lines[-1])
    check(all(k in full for k in BENCH_KEYS + ("compile_warm_s", "e2e")),
          f"bench's record lacks keys: {sorted(full)}")
    share = full["e2e"]["data_time_share"]
    check(0.0 <= share <= 1.0 and full["e2e"]["value"] > 0, f"bench e2e {full['e2e']}")
    log(f"[bench] python -m probabilisticteacher_torch.bench {' '.join(BENCH_CHILD_ARGS)}: "
        f"{child_s!r} s (proxy written in {proxy_s!r} s); record {lines[-1]}")
    out = {"worker": {k: rec[k] for k in ("value", "windows", "spread", "step_ms", "compile_s",
                                          "conv_tflop_per_iter", "conv_mfu", "device")},
           "worker_s": worker_s,
           "orchestrated": {k: full[k] for k in ("value", "step_ms", "compile_s",
                                                 "compile_warm_s", "conv_mfu", "e2e")},
           "orchestrated_s": child_s}
    gen = torch.Generator().manual_seed(12)
    cases = {
        "roi_align_fwd": {label: fwd_check_and_time(dev, gen, label, n, r, BENCH_FEAT)
                          for label, n, r in BENCH_FWD},
        "roi_align_bwd": {label: bwd_check_and_time(dev, label, n, r, BENCH_FEAT)
                          for label, n, r in BENCH_BWD},
        "nms_keep": {label: nms_check_and_time(dev, gen, label, *case, canvas=BENCH_CANVAS)
                     for label, *case in BENCH_NMS},
    }
    return {"out": out, "launches": {"bench_worker": counts}, "calls": {"bench_worker": calls},
            "cases": cases}


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

    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn(dev)
        phase_s[name] = time.perf_counter() - t
        return out

    k_roi = timed("roi_align", phase_roi_align)
    k_bwd = timed("roi_align_bwd", phase_roi_align_bwd)
    k_nms = timed("nms", phase_nms)
    sl = timed("slice", phase_slice)
    timed("reference", phase_reference)
    tr = timed("train", phase_train)
    timed("train_reference", phase_train_reference)
    cli, dp_cli = timed("cli", phase_cli)
    dp = timed("dp", phase_dp)
    lv = timed("levers", phase_levers)
    px = timed("proxy", phase_proxy)
    bn = timed("bench", phase_bench)

    launches, calls = {}, {}
    for ph in (sl, tr, cli, dp_cli, dp, lv, px, bn):
        launches.update(ph["launches"])
        calls.update(ph["calls"])
    for entry, k in ((k_roi, roi_align_cuda.KERNEL), (k_bwd, roi_align_cuda.BWD_KERNEL),
                     (k_nms, nms_cuda.KERNEL)):
        per = {path: c[k.symbol] for path, c in launches.items()}
        entry["launches"] = sum(per.values())
        entry["launches_by_path"] = per
        entry["calls_by_path"] = calls
        entry["cases"].update(px["cases"][entry["name"]])
        entry["cases"].update(bn["cases"][entry["name"]])
    log(json.dumps({"slice": {k: v for k, v in sl.items() if k not in ("launches", "calls")},
                    "train": tr["out"], "cli": cli["out"], "dp_cli": dp_cli["out"],
                    "dp": dp["out"], "levers": lv["out"], "proxy": px["out"], "bench": bn["out"],
                    "build_s": build_s, "phase_s": phase_s,
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
