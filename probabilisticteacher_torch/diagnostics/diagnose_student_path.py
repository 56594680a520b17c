"""What a throughput lever does to the student's training path (the port of
``scripts/diagnose_student_path.py``).

    python -m probabilisticteacher_torch.diagnostics.diagnose_student_path [--n 8]
        [--short 480] [--data DIR] [--weights CKPT] [--slot student|teacher]
        [--device cuda|cpu] [KEY VALUE ...]

``diagnose_levers`` reads the teacher's weak pass and cannot see a lever that
reshapes the student's proposals. This runs the student's RPN proposals in training
mode (train budgets, sigma-rescored NMS) on labeled foggy proxy images and prints,
per lever variant, the JAX script's line:

- gt-recall@0.5: the share of ground-truth boxes covered by a post-NMS proposal at
  IoU >= 0.5, an upper bound on the objects that can give foreground ROI samples
  (the ROI matcher's foreground threshold is 0.5);
- fg-pool/img: proposals whose best IoU with a ground-truth box reaches 0.5, the
  pool the 512 @ 0.25 ROI subsample draws its foregrounds from;
- agreement-vs-exact@0.9: the share of the exact path's proposals that the variant
  reproduces at IoU >= 0.9, how far the lever moves the training distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.boxes import pairwise_iou
from .diagnose_levers import recall_at
from .proxy_setup import build_parser, load_proxy_setup


def variants(base_arch) -> Dict[str, dict]:
    """The JAX script's five variants (``diagnose_student_path.py:55-63``), the exact
    path first."""
    pre_test = base_arch.rpn_pre_nms_topk[0]
    return {
        "exact (pre 6000)": {},
        "pre4000": {"rpn_pre_nms_topk": (pre_test, 4000)},
        "hybrid": {"rpn_nms_impl": "hybrid"},
        "hybrid+pre4000": {"rpn_nms_impl": "hybrid", "rpn_pre_nms_topk": (pre_test, 4000)},
        "pre2000": {"rpn_pre_nms_topk": (pre_test, 2000)},
    }


@torch.no_grad()
def train_proposals(det, batch) -> List[torch.Tensor]:
    """The valid training-mode proposals of each image, on the CPU."""
    feat = det.features(batch)
    obj, deltas = det.rpn_predict(feat)
    anchors = det.anchors(feat.shape[1], feat.shape[2])
    pr = det.predict_proposals(anchors, obj, deltas, batch.image_hw, training=True,
                               grid_hw=feat.shape[1:3])
    boxes, valid = pr.boxes.cpu(), pr.valid.cpu()
    return [boxes[i][valid[i]] for i in range(boxes.shape[0])]


def run(args, names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Every variant (or those of ``names``; the exact path always runs first), its
    line printed; returns each variant's readings."""
    _, base_arch, det, batch, imgs = load_proxy_setup(args.n, args.short, args.data,
                                                      args.weights, require_gt=True,
                                                      device=args.device, opts=args.opts,
                                                      slot=args.slot)
    gts = [torch.from_numpy(o["gt_boxes"][o["gt_valid"].astype(bool)]) for o in imgs]
    results, ref = {}, None
    for i, (name, over) in enumerate(variants(base_arch).items()):
        if names is not None and i > 0 and name not in names:
            continue
        det.arch = dataclasses.replace(base_arch, **over)
        props = train_proposals(det, batch)
        fg_pool = sum(int((pairwise_iou(g, p).max(dim=0).values >= 0.5).sum())
                      for g, p in zip(gts, props) if len(g))
        if ref is None:
            ref, agree = props, 1.0
        else:
            agree = recall_at([r if len(p) else r[:0] for r, p in zip(ref, props)], props, 0.9)
        r = results[name] = {"gt_recall": recall_at(gts, props, 0.5),
                             "fg_pool_per_img": fg_pool / args.n, "agreement": agree,
                             "proposals_per_image": [len(p) for p in props]}
        print(f"{name:>18}: gt-recall@0.5 {r['gt_recall']:6.1%}  "
              f"fg-pool/img {r['fg_pool_per_img']:7.1f}  "
              f"agreement-vs-exact@0.9 {agree:6.1%}", flush=True)
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(build_parser(__doc__.splitlines()[0]).parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
