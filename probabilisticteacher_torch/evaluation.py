"""Host-side detection evaluators: Pascal VOC07 11-point AP and COCO AP.

The port's copy of the JAX package's ``evaluation.py``. It replaces the
reference's use of detectron2 ``PascalVOCDetectionEvaluator`` (VOC07 11-point
AP@50, the headline Cityscapes->Foggy metric, ``pt/engine/trainer.py:128-137``)
and ``COCOEvaluator``. The VOC path is a numpy re-implementation of the published
protocol; the COCO path (``style="coco"``) delegates to
:class:`probabilisticteacher_torch.cocoeval.COCOEvaluator`, a pycocotools-parity
re-implementation (exact greedy matcher, 101-point recall grid, area ranges,
maxDets 1/10/100; see cocoeval.py).

:func:`evaluate_detections` runs :meth:`PTDetector.detect` under
``torch.inference_mode()`` on the detector's device. Detections arrive in canvas
coordinates and are rescaled to original image coordinates by dividing by the
loader's per-image ``scale``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = True) -> float:
    """VOC AP given recall/precision curves (11-point when use_07_metric)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _match_and_pr(dets: List[dict], gts: Dict, npos: int, iou_thresh: float):
    """Greedy per-class matching by descending score (VOC protocol)."""
    dets = sorted(dets, key=lambda d: -d["score"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        g = gts.get(det["image_id"])
        if g is None or len(g["boxes"]) == 0:
            fp[i] = 1.0
            continue
        bb = np.asarray(det["bbox"], np.float32)
        gb = g["boxes"]
        ixmin = np.maximum(gb[:, 0], bb[0])
        iymin = np.maximum(gb[:, 1], bb[1])
        ixmax = np.minimum(gb[:, 2], bb[2])
        iymax = np.minimum(gb[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inter = iw * ih
        union = (
            (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
            + (gb[:, 2] - gb[:, 0] + 1.0) * (gb[:, 3] - gb[:, 1] + 1.0)
            - inter
        )
        overlaps = inter / np.maximum(union, 1e-9)
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > iou_thresh:
            if g["difficult"][jmax]:
                continue  # ignore, neither tp nor fp
            if not g["matched"][jmax]:
                tp[i] = 1.0
                g["matched"][jmax] = True
            else:
                fp[i] = 1.0
        else:
            fp[i] = 1.0
    cum_fp = np.cumsum(fp)
    cum_tp = np.cumsum(tp)
    rec = cum_tp / max(npos, 1)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, np.finfo(np.float64).eps)
    return rec, prec


def DetectionEvaluator(class_names: Sequence[str], style: str = "voc"):
    """Evaluator factory: "voc" -> :class:`VOCDetectionEvaluator` (VOC07 11-point
    AP@50, +1 box convention, matching detectron2 pascal_voc_evaluation);
    "coco" -> :class:`cocoeval.COCOEvaluator` (pycocotools parity)."""
    if style == "coco":
        from .cocoeval import COCOEvaluator

        return COCOEvaluator(class_names)
    return VOCDetectionEvaluator(class_names)


class VOCDetectionEvaluator:
    """Accumulates (image_id, class, box, score) + GT; VOC07 11-point AP@50."""

    def __init__(self, class_names: Sequence[str], style: str = "voc"):
        self.class_names = list(class_names)
        self.style = style
        self.reset()

    def reset(self):
        self._dets: Dict[int, List[dict]] = defaultdict(list)       # class -> list
        self._gts: Dict[int, Dict] = defaultdict(dict)               # class -> image -> g
        self._npos: Dict[int, int] = defaultdict(int)

    def add_ground_truth(self, image_id, boxes: np.ndarray, classes: np.ndarray,
                         difficult: np.ndarray = None):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        classes = np.asarray(classes).reshape(-1)
        if difficult is None:
            difficult = np.zeros(len(boxes), bool)
        for c in np.unique(classes):
            sel = classes == c
            g = {
                "boxes": boxes[sel],
                "difficult": difficult[sel].astype(bool),
                "matched": np.zeros(int(sel.sum()), bool),
            }
            self._gts[int(c)][image_id] = g
            self._npos[int(c)] += int((~g["difficult"]).sum())

    def add_detections(self, image_id, boxes: np.ndarray, scores: np.ndarray,
                       classes: np.ndarray):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        for box, score, c in zip(boxes, np.asarray(scores), np.asarray(classes)):
            self._dets[int(c)].append(
                {"image_id": image_id, "bbox": box, "score": float(score)}
            )

    def _evaluate_at(self, iou_thresh: float, use_07: bool) -> Dict[str, float]:
        import copy

        aps = {}
        for c, name in enumerate(self.class_names):
            gts = copy.deepcopy(self._gts.get(c, {}))
            rec, prec = _match_and_pr(self._dets.get(c, []), gts, self._npos.get(c, 0), iou_thresh)
            if len(rec) == 0:
                aps[name] = 0.0
            else:
                aps[name] = _voc_ap(rec, prec, use_07)
        return aps

    def evaluate(self) -> Dict[str, float]:
        aps = self._evaluate_at(0.5, use_07=True)
        out = {f"AP50-{k}": v * 100 for k, v in aps.items()}
        out["mAP50"] = float(np.mean(list(aps.values()))) * 100 if aps else 0.0
        out["bbox/AP50"] = out["mAP50"]
        return out


def _fetch(dets) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.cuda.Event]]:
    """Start the copy of a batch's detections to the host; on the card, return the
    event to wait on before reading them (the copy is queued behind ``detect``)."""
    fields = (dets.boxes, dets.scores, dets.classes, dets.valid)
    if not dets.boxes.is_cuda:
        return fields, None
    host = tuple(t.to("cpu", non_blocking=True) for t in fields)
    event = torch.cuda.Event()
    event.record()
    return host, event


def evaluate_detections(detector, loader, class_names, style="voc", max_images: int = 0,
                        gt_dicts: List[dict] = None) -> Dict[str, float]:
    """Run ``detector.detect`` over an EvalLoader and compute metrics.

    ``detector`` is a :class:`PTDetector`; batches go to its device. Batch i's
    detect is queued before batch i-1's detections are read on the host, so the
    evaluator's host work overlaps the device. When ``gt_dicts`` is given, GT
    comes from the raw annotations (keeping the VOC ``difficult`` flags and boxes
    beyond the loader's MAX_GT padding budget); otherwise it is reconstructed from
    the padded batches.
    """
    from .parallel.prefetch import host_to_device
    from .structures import ImageBatch

    evaluator = DetectionEvaluator(class_names, style)
    if gt_dicts is not None:
        for d in gt_dicts:
            annos = d.get("annotations", [])
            evaluator.add_ground_truth(
                d["image_id"],
                np.asarray([a["bbox"] for a in annos], np.float32).reshape(-1, 4),
                np.asarray([a["category_id"] for a in annos], np.int64).reshape(-1),
                np.asarray([a.get("difficult", 0) for a in annos], bool).reshape(-1),
            )
    dev = detector.device

    def consume(batch, fetched):
        fields, event = fetched
        if event is not None:
            event.synchronize()
        boxes, scores, classes, valid = (t.numpy() for t in fields)
        for j, image_id in enumerate(batch["image_id"]):
            if image_id is None:  # EvalLoader batch padding
                continue
            scale = float(batch["scale"][j])
            if gt_dicts is None:
                gsel = batch["gt_valid"][j]
                evaluator.add_ground_truth(
                    image_id,
                    batch["gt_boxes"][j][gsel] / scale,
                    batch["gt_classes"][j][gsel],
                )
            v = valid[j]
            evaluator.add_detections(
                image_id, boxes[j][v] / scale, scores[j][v], classes[j][v]
            )

    pending = None
    with torch.inference_mode():
        for i, batch in enumerate(loader):
            if max_images and i >= max_images:
                break
            images = ImageBatch(host_to_device(batch["image"], dev),
                                host_to_device(batch["image_hw"], dev))
            fetched = _fetch(detector.detect(images))
            if pending is not None:
                consume(*pending)
            pending = (batch, fetched)
        if pending is not None:
            consume(*pending)
    return evaluator.evaluate()
