"""COCO detection AP with pycocotools-parity semantics (pure numpy, bbox only).

The reference evaluates COCO-format datasets through detectron2's ``COCOEvaluator``
(``pt/engine/trainer.py:131-133``), which defers to ``pycocotools.cocoeval.COCOeval``.
This module, the port's copy of the JAX package's ``cocoeval.py``, needs no
pycocotools: it is a faithful re-implementation of the published algorithm (bbox
iouType) — the exact per-image greedy matcher (crowd re-matching, ignore
propagation), the (T, R, K, A, M) accumulate with the 101-point recall grid and the monotone precision envelope, and
the 12-metric summarize table:

    AP, AP50, AP75, APs, APm, APl, AR@1, AR@10, AR@100, ARs, ARm, ARl

Semantics mirrored from pycocotools cocoeval.py (COCO API, Lin et al.):
- boxes are XYWH; IoU has no +1 convention; for crowd GT, IoU = inter / det_area;
- per (image, category): dets sorted by -score (stable), capped at maxDet; GTs
  sorted ignored-last; a det may match an already-matched crowd GT; once a
  non-ignored candidate exists, ignored GTs are not considered (break);
- unmatched dets whose area is outside the range are ignored (not FP);
- accumulate: tps/fps over non-ignored dets; precision interpolated onto
  recThrs = linspace(0, 1, 101) via searchsorted after the running-max envelope;
- AP = mean over precision > -1 (categories with no GT contribute -1 = excluded).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

# pycocotools defaults (cocoeval.Params for iouType='bbox')
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = (
    ("all", (0.0, 1e5 ** 2)),
    ("small", (0.0, 32.0 ** 2)),
    ("medium", (32.0 ** 2, 96.0 ** 2)),
    ("large", (96.0 ** 2, 1e5 ** 2)),
)


def iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools ``maskUtils.iou`` for bboxes: (D, G) matrix, XYWH, no +1.

    For crowd GT columns the denominator is the det area alone (a det fully inside
    a crowd region scores IoU 1 regardless of the region's size).
    """
    d = np.asarray(dets, np.float64).reshape(-1, 4)
    g = np.asarray(gts, np.float64).reshape(-1, 4)
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    ix = np.minimum(d[:, None, 0] + d[:, None, 2], g[None, :, 0] + g[None, :, 2]) - \
        np.maximum(d[:, None, 0], g[None, :, 0])
    iy = np.minimum(d[:, None, 1] + d[:, None, 3], g[None, :, 1] + g[None, :, 3]) - \
        np.maximum(d[:, None, 1], g[None, :, 1])
    inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def _evaluate_img(dts: List[dict], gts: List[dict], ious: np.ndarray,
                  area_rng, max_det: int) -> Optional[dict]:
    """COCOeval.evaluateImg for one (image, category, areaRng, maxDet=largest).

    dts: [{'score', 'area', 'id'}...] pre-sorted by -score and capped at max_det;
    gts: [{'area', 'iscrowd', 'ignore', 'id'}...]; ious: (len(dts), len(gts))
    in the ORIGINAL (pre-sort) gt order matching the gts list order here.
    """
    if len(dts) == 0 and len(gts) == 0:
        return None
    t_n = len(IOU_THRS)
    g_ig = np.array([
        1 if (g["ignore"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]) else 0
        for g in gts
    ])
    # sort gts: non-ignored first (stable)
    gt_order = np.argsort(g_ig, kind="mergesort")
    gts_s = [gts[i] for i in gt_order]
    g_ig = g_ig[gt_order]
    iscrowd = [int(g.get("iscrowd", 0)) for g in gts_s]
    ious_s = ious[:, gt_order] if ious.size else ious

    d_n, g_n = len(dts), len(gts_s)
    gtm = np.zeros((t_n, g_n))
    dtm = np.zeros((t_n, d_n))
    dt_ig = np.zeros((t_n, d_n))
    if g_n and d_n:
        # the published greedy T x D x G scan, on plain Python lists — numpy
        # scalar indexing in this hot loop is ~10x slower than list access at
        # the tiny per-(image, category) shapes (D <= 100, G ~ 2-10)
        iou_rows = ious_s.tolist()
        gig = g_ig.tolist()
        gt_ids = [g["id"] for g in gts_s]
        dt_ids = [d["id"] for d in dts]
        gtm_l = [[0.0] * g_n for _ in range(t_n)]
        dtm_l = [[0.0] * d_n for _ in range(t_n)]
        dtig_l = [[0.0] * d_n for _ in range(t_n)]
        for tind, t in enumerate(IOU_THRS):
            gtm_row, dtm_row, dtig_row = gtm_l[tind], dtm_l[tind], dtig_l[tind]
            t0 = min(t, 1 - 1e-10)
            for dind in range(d_n):
                row = iou_rows[dind]
                iou = t0
                m = -1
                for gind in range(g_n):
                    if gtm_row[gind] > 0 and not iscrowd[gind]:
                        continue
                    if m > -1 and gig[m] == 0 and gig[gind] == 1:
                        break
                    v = row[gind]
                    if v < iou:
                        continue
                    iou = v
                    m = gind
                if m == -1:
                    continue
                dtig_row[dind] = gig[m]
                dtm_row[dind] = gt_ids[m]
                gtm_row[m] = dt_ids[dind]
        gtm = np.asarray(gtm_l)
        dtm = np.asarray(dtm_l)
        dt_ig = np.asarray(dtig_l)
    # ignore unmatched dets outside the area range
    a = np.array([d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts])
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.tile(a, (t_n, 1))))
    return {
        "dtMatches": dtm,
        "dtScores": np.array([d["score"] for d in dts]),
        "gtIgnore": g_ig,
        "dtIgnore": dt_ig,
        "num_gt": int(np.count_nonzero(g_ig == 0)),
    }


class COCOEvaluator:
    """Accumulates detections + GT and computes the 12 COCO bbox metrics.

    API mirrors :class:`evaluation.DetectionEvaluator`; boxes are XYXY at entry
    (converted to XYWH internally — detectron2 does the same conversion before
    handing to pycocotools).
    """

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.reset()

    def reset(self):
        self._gt = defaultdict(list)   # (image_id, cat) -> [gt dict]
        self._dt = defaultdict(list)   # (image_id, cat) -> [dt dict]
        self._img_ids = {}             # insertion-ordered set
        self._next_gt_id = 1
        self._next_dt_id = 1

    def add_ground_truth(self, image_id, boxes, classes, difficult=None, iscrowd=None):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        classes = np.asarray(classes).reshape(-1)
        difficult = (np.zeros(len(boxes), bool) if difficult is None
                     else np.asarray(difficult, bool).reshape(-1))
        iscrowd = (np.zeros(len(boxes), bool) if iscrowd is None
                   else np.asarray(iscrowd, bool).reshape(-1))
        self._img_ids[image_id] = True
        for b, c, dif, cr in zip(boxes, classes, difficult, iscrowd):
            w, h = b[2] - b[0], b[3] - b[1]
            self._gt[(image_id, int(c))].append({
                "bbox": [b[0], b[1], w, h], "area": float(w * h),
                "iscrowd": bool(cr), "ignore": bool(dif or cr),
                "id": self._next_gt_id,
            })
            self._next_gt_id += 1

    def add_detections(self, image_id, boxes, scores, classes):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        self._img_ids[image_id] = True
        for b, s, c in zip(boxes, np.asarray(scores), np.asarray(classes)):
            w, h = b[2] - b[0], b[3] - b[1]
            self._dt[(image_id, int(c))].append({
                "bbox": [b[0], b[1], w, h], "area": float(w * h),
                "score": float(s), "id": self._next_dt_id,
            })
            self._next_dt_id += 1

    # ------------------------------------------------------------------ eval
    def _accumulate(self):
        cats = range(len(self.class_names))
        imgs = list(self._img_ids)
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.class_names), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        max_det_cap = max(MAX_DETS)

        for k in cats:
            # per-image sorted det lists + IoUs computed ONCE per (img, cat)
            per_img = []
            for img in imgs:
                gts = self._gt.get((img, k), [])
                dts = sorted(self._dt.get((img, k), []),
                             key=lambda d: -d["score"])[:max_det_cap]
                ious = iou_xywh(
                    np.array([d["bbox"] for d in dts]).reshape(-1, 4),
                    np.array([g["bbox"] for g in gts]).reshape(-1, 4),
                    np.array([g["iscrowd"] for g in gts], bool),
                ) if dts and gts else np.zeros((len(dts), len(gts)))
                per_img.append((dts, gts, ious))

            for a, (_, rng) in enumerate(AREA_RNG):
                evals_full = [
                    _evaluate_img(dts, gts, ious, rng, max_det_cap)
                    for dts, gts, ious in per_img
                ]
                for m, max_det in enumerate(MAX_DETS):
                    evals = [e for e in evals_full if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dtScores"][:max_det] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtMatches"][:, :max_det] for e in evals],
                                         axis=1)[:, order]
                    dt_ig = np.concatenate([e["dtIgnore"][:, :max_det] for e in evals],
                                           axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(len(IOU_THRS)):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # monotone envelope: pr[i-1] = max(pr[i-1], pr[i]) from
                        # the end == reverse cummax (vectorized, identical)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        q = np.zeros(R)
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        ok = inds < nd
                        q[ok] = pr[inds[ok]]
                        precision[t, :, k, a, m] = q
        return precision, recall

    def evaluate(self) -> Dict[str, float]:
        precision, recall = self._accumulate()

        def _summ(ap, iou=None, area="all", max_det=100):
            aind = [i for i, (lbl, _) in enumerate(AREA_RNG) if lbl == area]
            mind = [i for i, md in enumerate(MAX_DETS) if md == max_det]
            if ap:
                s = precision
                if iou is not None:
                    s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
                s = s[:, :, :, aind, mind]
            else:
                s = recall
                if iou is not None:
                    s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
                s = s[:, :, aind, mind]
            valid = s[s > -1]
            return float(np.mean(valid)) * 100 if valid.size else float("nan")

        out = {
            "bbox/AP": _summ(True),
            "bbox/AP50": _summ(True, iou=0.5),
            "bbox/AP75": _summ(True, iou=0.75),
            "bbox/APs": _summ(True, area="small"),
            "bbox/APm": _summ(True, area="medium"),
            "bbox/APl": _summ(True, area="large"),
            "bbox/AR@1": _summ(False, max_det=1),
            "bbox/AR@10": _summ(False, max_det=10),
            "bbox/AR@100": _summ(False, max_det=100),
            "bbox/ARs": _summ(False, area="small"),
            "bbox/ARm": _summ(False, area="medium"),
            "bbox/ARl": _summ(False, area="large"),
        }
        # per-class AP50 like detectron2's COCOEvaluator per-category table
        for k, name in enumerate(self.class_names):
            p = precision[np.where(np.isclose(IOU_THRS, 0.5))[0], :, k, 0, -1]
            valid = p[p > -1]
            out[f"AP50-{name}"] = float(np.mean(valid)) * 100 if valid.size else float("nan")
        out["mAP50"] = out["bbox/AP50"]
        return out
