"""The training batches, worked out again from the files: read, decode, resize, flip,
pad, in the loader's sampling order.

A frozen copy of the decode path of ``probabilisticteacher_torch/data`` (the VOC
reader, ``SemiSupLoader``'s sampling and aspect buckets, ``Mapper``'s PIL path) as
it stood when the benchmark was written, without threads: the same seeds give the
same images, flips and boxes in the same order.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image


def load_voc(dirname: str, split: str, class_names: Sequence[str]) -> List[dict]:
    """detectron2 ``load_voc_instances``: XYXY boxes with x1, y1 moved by -1 (VOC is
    1-indexed)."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    name_to_id = {n: i for i, n in enumerate(class_names)}
    dicts = []
    for fid in ids:
        tree = ET.parse(os.path.join(dirname, "Annotations", fid + ".xml"))
        annos = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in name_to_id:
                continue
            bb = obj.find("bndbox")
            x1, y1, x2, y2 = (float(bb.find(t).text) for t in ("xmin", "ymin", "xmax", "ymax"))
            annos.append({"category_id": name_to_id[cls], "bbox": [x1 - 1.0, y1 - 1.0, x2, y2]})
        dicts.append({"file_name": os.path.join(dirname, "JPEGImages", fid + ".jpg"),
                      "image_id": fid,
                      "height": int(float(tree.findall("./size/height")[0].text)),
                      "width": int(float(tree.findall("./size/width")[0].text)),
                      "annotations": annos})
    return dicts


class Mapper:
    """ResizeShortestEdge + random horizontal flip + zero padding onto the aspect
    bucket's canvas; ground truth clipped, emptied boxes dropped, padded to
    ``max_gt``. Pixels in BGR order."""

    def __init__(self, short_sizes: Sequence[int], max_size: int, canvas_wide, canvas_tall,
                 max_gt: int, flip: bool = True):
        self.short_sizes = tuple(short_sizes)
        self.max_size = max_size
        self.canvas_wide = tuple(canvas_wide)
        self.canvas_tall = tuple(canvas_tall)
        self.max_gt = max_gt
        self.flip = flip

    def __call__(self, record: dict, rng: np.random.Generator) -> Dict:
        annos = record.get("annotations", [])
        boxes = np.asarray([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in annos], np.int64).reshape(-1)
        short = int(rng.choice(self.short_sizes))
        flip = bool(self.flip and rng.random() < 0.5)
        img = np.asarray(Image.open(record["file_name"]).convert("RGB"), dtype=np.uint8)[:, :, ::-1]
        h, w = img.shape[:2]
        scale = short / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if (nh, nw) != (h, w):
            img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
        if boxes.size:
            boxes = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
        if flip:
            img = img[:, ::-1]
            if boxes.size:
                boxes = boxes.copy()
                x1 = boxes[:, 0].copy()
                boxes[:, 0] = nw - boxes[:, 2]
                boxes[:, 2] = nw - x1
        h, w = img.shape[:2]
        bucket = 0 if w > h else 1
        ch, cw = self.canvas_wide if bucket == 0 else self.canvas_tall
        img = img[:ch, :cw]
        h, w = img.shape[:2]
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[:h, :w] = img
        g = self.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        if boxes.size:
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes = boxes[keep][:g], classes[keep][:g]
            gt_boxes[:len(boxes)] = boxes
            gt_classes[:len(boxes)] = classes
            gt_valid[:len(boxes)] = True
        return {"image": canvas, "image_hw": np.asarray([h, w], np.float32),
                "gt_boxes": gt_boxes, "gt_classes": gt_classes, "gt_valid": gt_valid,
                "bucket": bucket, "image_id": record["image_id"]}


def _stack(records: Sequence[dict]) -> Dict:
    out = {k: np.stack([r[k] for r in records])
           for k in ("image", "image_hw", "gt_boxes", "gt_classes", "gt_valid")}
    out["image_id"] = [r["image_id"] for r in records]
    return out


def _shuffled(n: int, seed: int) -> Iterator[int]:
    rng = np.random.Generator(np.random.PCG64(seed))
    while True:
        for i in rng.permutation(n):
            yield int(i)


def batches(label_dicts: List[dict], unlabel_dicts: List[dict], mapper: Mapper, seed: int,
            bs_label: int, bs_unlabel: int, chunk: int) -> Iterator[Dict]:
    """{"label": batch, "unlabel": batch} in the loader's order: each stream draws
    ``chunk`` records at a time into two aspect buckets until both have a full one;
    the sample counter that seeds each record's draws runs over both streams."""
    label_dicts = [d for d in label_dicts if d.get("annotations")]
    streams = {"l": (label_dicts, _shuffled(len(label_dicts), seed + 2)),
               "u": (unlabel_dicts, _shuffled(len(unlabel_dicts), seed + 3))}
    buckets = {"l": {0: [], 1: []}, "u": {0: [], 1: []}}
    size = {"l": bs_label, "u": bs_unlabel}
    counter = 0

    def ready(s: str) -> Optional[int]:
        full = [b for b in (0, 1) if len(buckets[s][b]) >= size[s]]
        return max(full, key=lambda b: len(buckets[s][b])) if full else None

    while True:
        bl, bu = ready("l"), ready("u")
        if bl is not None and bu is not None:
            out = {}
            for s, b in (("l", bl), ("u", bu)):
                out[s] = _stack(buckets[s][b][:size[s]])
                buckets[s][b] = buckets[s][b][size[s]:]
            yield {"label": out["l"], "unlabel": out["u"]}
            continue
        for s, b in (("l", bl), ("u", bu)):
            if b is not None:
                continue
            dicts, order = streams[s]
            for _ in range(chunk):
                counter += 1
                rec = mapper(dicts[next(order)],
                             np.random.Generator(np.random.PCG64(seed * 1_000_003 + counter)))
                buckets[s][rec["bucket"]].append(rec)
