"""Which throughput lever degrades the teacher's pseudo-labels (the port of
``scripts/diagnose_levers.py``).

    python -m probabilisticteacher_torch.diagnostics.diagnose_levers [--n 8] [--short 480]
        [--data DIR] [--weights CKPT] [--slot student|teacher] [--device cuda|cpu]
        [KEY VALUE ...]

Loads the student slot of a source-only checkpoint (``proxy_setup``; ``--slot
teacher`` reads the EMA teacher of a mutual-learning one), runs the
teacher's weak pass (``pseudo_labels``) on real foggy proxy images under each lever
variant, and compares it with the exact path: detections per image (the valid ones,
which ``num_pseudo_boxes`` counts in training), detections whose confidence (softmax
without the background class, max over classes) reaches ``TAU[0]``, and the share of
the exact path's confident boxes that the variant covers at IoU >= 0.5. Each
variant's line is the JAX script's; a second line gives the valid detections of each
image, the count that card and CPU runs of the same weights are compared on, and how
many of them have no area (clipped to a line at the image's edge: such a pseudo box
overlaps no anchor, and the RPN matcher's low-quality rule then labels every anchor
of its image positive in the unsupervised RPN loss).

Blind spot: this sees only the teacher's weak pass. Levers that touch the student's
training path (``PRE_NMS_TOPK_TRAIN``, the hybrid NMS in training) need
``diagnose_student_path`` as well.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.boxes import area as box_area
from ..ops.boxes import pairwise_iou
from ..structures import PseudoLabels
from .proxy_setup import build_parser, load_proxy_setup


def variants(base_arch) -> Dict[str, dict]:
    """The JAX script's eight variants (``diagnose_levers.py:48-69``) as ``Arch``
    fields, the exact path first."""
    pre_test = base_arch.rpn_pre_nms_topk[0]
    return {
        "exact": {},
        "hybrid": {"rpn_nms_impl": "hybrid"},
        "teacher1000": {"teacher_pre_nms_topk": 6000, "teacher_post_nms_topk": 1000},
        "cand2048": {"teacher_nms_candidates": 2048},
        "pre4000": {"rpn_pre_nms_topk": (pre_test, 4000)},
        "combo": {"rpn_pre_nms_topk": (pre_test, 4000),
                  "teacher_pre_nms_topk": 4000, "teacher_post_nms_topk": 1000,
                  "teacher_nms_candidates": 2048},
        "combo_hybrid": {"rpn_nms_impl": "hybrid",
                         "rpn_pre_nms_topk": (pre_test, 4000),
                         "teacher_pre_nms_topk": 4000,
                         "teacher_post_nms_topk": 1000,
                         "teacher_nms_candidates": 2048},
        # teacher-side levers only: the student's path stays exact
        "teacher1000_cand2048": {"teacher_pre_nms_topk": 6000,
                                 "teacher_post_nms_topk": 1000,
                                 "teacher_nms_candidates": 2048},
    }


def confident(pl: PseudoLabels, tau: float) -> torch.Tensor:
    """(N, D) valid detections whose max foreground probability reaches ``tau``."""
    conf = torch.softmax(pl.logits, dim=-1)[..., :-1].max(dim=-1).values
    return (conf >= tau) & pl.valid


def recall_at(ref: List[torch.Tensor], boxes: List[torch.Tensor], thresh: float) -> float:
    """Share of the boxes of ``ref`` that some box of ``boxes`` (same image) covers at
    IoU >= ``thresh``; 0 when ``ref`` is empty."""
    hit = tot = 0
    for r, b in zip(ref, boxes):
        if not len(r):
            continue
        tot += len(r)
        if len(b):
            hit += int((pairwise_iou(r, b).max(dim=1).values >= thresh).sum())
    return hit / max(tot, 1)


def run(args, names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Every variant (or those of ``names``; the exact path always runs first), its
    line printed; returns each variant's readings."""
    cfg, base_arch, det, batch, _ = load_proxy_setup(args.n, args.short, args.data,
                                                     args.weights, device=args.device,
                                                     opts=args.opts, slot=args.slot)
    tau = float(cfg.UNSUPNET.TAU[0])
    results, ref = {}, None
    for name, over in variants(base_arch).items():
        if names is not None and name != "exact" and name not in names:
            continue
        det.arch = dataclasses.replace(base_arch, **over)
        pl = PseudoLabels(*(t.cpu() for t in det.pseudo_labels(batch)))
        keep = confident(pl, tau)
        boxes = [pl.boxes[i][keep[i]] for i in range(args.n)]
        if ref is None:
            ref, recall = boxes, 1.0
        else:
            recall = recall_at(ref, boxes, 0.5)
        valid = pl.valid.sum(dim=1).tolist()
        flat = (box_area(pl.boxes) <= 0) & pl.valid
        results[name] = {"dets_per_img": float(pl.valid.float().sum()) / args.n,
                         "conf_tau_per_img": float(keep.float().sum()) / args.n,
                         "recall": recall, "valid_per_image": valid,
                         "zero_area_per_image": flat.sum(dim=1).tolist()}
        r = results[name]
        print(f"{name:>22}: dets/img {r['dets_per_img']:5.1f}  "
              f"conf>=tau/img {r['conf_tau_per_img']:5.1f}  "
              f"recall-vs-exact@0.5 {recall:5.1%}", flush=True)
        print(f"{'':>22}  valid per image {valid}; of no area "
              f"{r['zero_area_per_image']}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser(__doc__.splitlines()[0]).parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
