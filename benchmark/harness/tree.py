"""The image tree a cell reads: synthetic street scenes written once per checkout as a
VOC-layout tree of JPEGs (``JPEGImages/``, ``Annotations/``, ``ImageSets/Main/``).

The scene model is a frozen copy of ``scripts/make_daod_proxy.py`` (gradient
background with clutter and noise, objects of eight shape and colour families, fog
for the target domain), drawn at the stored size that the traffic names: a
dataset's own image size ("native") or the size the loader resizes it to
("train"). Object sizes scale with the image. The tree depends only on the
dataset's parameters and the traffic's tree seed, never on a run's ``--seed``, so
every run of a cell reads the same files in its own order.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import shutil
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter

_STYLES = {
    "truck": ((200, 60, 40), "rect"),
    "car": ((40, 90, 200), "rect"),
    "rider": ((220, 170, 40), "ellipse"),
    "person": ((200, 40, 160), "ellipse"),
    "train": ((40, 180, 70), "rect"),
    "motorcycle": ((90, 220, 210), "tri"),
    "bicycle": ((240, 240, 90), "tri"),
    "bus": ((130, 70, 220), "rect"),
}
REF_WIDTH = 960      # the proxy's width, at which its object sizes were chosen


def stored_hw(hw: Sequence[int], scale: str, short: int, max_size: int) -> Tuple[int, int]:
    """(h, w) of the stored JPEG: the dataset's own size, or the loader's
    ResizeShortestEdge(short, max_size) of it."""
    h, w = int(hw[0]), int(hw[1])
    if scale == "native":
        return h, w
    if scale != "train":
        raise ValueError(f"stored scale {scale!r} is neither 'native' nor 'train'")
    s = short / min(h, w)
    if max(h, w) * s > max_size:
        s = max_size / max(h, w)
    return int(round(h * s)), int(round(w * s))


def _background(rng, h, w):
    top = rng.randint(120, 200, 3)
    bot = rng.randint(40, 110, 3)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (top * (1 - ramp) + bot * ramp).astype(np.float32)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    for _ in range(rng.randint(4, 9)):
        cw, ch = rng.randint(w // 8, w // 3), rng.randint(h // 8, h // 3)
        x, y = rng.randint(0, w - cw), rng.randint(0, h - ch)
        img[y:y + ch, x:x + cw] += rng.uniform(-35, 35, 3)
    img += rng.normal(0, 8, (h, w, 3)).astype(np.float32)
    return img


def _draw_object(rng, img, cls, box):
    x1, y1, x2, y2 = box
    color = np.asarray(_STYLES[cls][0], np.float32) + rng.uniform(-30, 30, 3)
    shape = _STYLES[cls][1]
    hh, ww = y2 - y1, x2 - x1
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    cy, cx = (hh - 1) / 2, (ww - 1) / 2
    if shape == "rect":
        mask = np.ones((hh, ww), bool)
    elif shape == "ellipse":
        mask = ((yy - cy) / max(cy, 1)) ** 2 + ((xx - cx) / max(cx, 1)) ** 2 <= 1.0
    else:
        mask = (yy / max(hh - 1, 1)) >= np.abs(xx - cx) / max(cx, 1)
    region = img[y1:y2, x1:x2]
    shade = 1.0 - 0.25 * (yy / max(hh - 1, 1))
    region[mask] = color[None, :] * shade[mask][:, None]
    if hh > 16 and ww > 16:
        sy, sx = rng.randint(2, hh // 3), rng.randint(2, ww // 3)
        region[sy:sy + hh // 6, sx:sx + ww // 4] *= 0.5
    img[y1:y2, x1:x2] = region


def _foggify(rng, img):
    t = rng.uniform(0.35, 0.55)
    air = rng.uniform(190, 220)
    out = img * t + air * (1.0 - t)
    pil = Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))
    pil = pil.filter(ImageFilter.GaussianBlur(radius=rng.uniform(1.0, 2.0)))
    return np.asarray(pil).astype(np.float32)


def _write_xml(path, w, h, objects):
    root = ET.Element("annotation")
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "height").text = str(h)
    ET.SubElement(size, "depth").text = "3"
    for name, (x1, y1, x2, y2) in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        ET.SubElement(obj, "difficult").text = "0"
        bb = ET.SubElement(obj, "bndbox")
        ET.SubElement(bb, "xmin").text = str(int(x1) + 1)
        ET.SubElement(bb, "ymin").text = str(int(y1) + 1)
        ET.SubElement(bb, "xmax").text = str(int(x2))
        ET.SubElement(bb, "ymax").text = str(int(y2))
    ET.ElementTree(root).write(path)


def _scene(job):
    """Write image ``i`` of a tree: (root, i, seed, (h, w), classes, (lo, hi) boxes,
    foggy, quality)."""
    root, i, seed, (h, w), classes, (lo, hi), foggy, quality = job
    rng = np.random.RandomState((seed * 1_000_003 + i) % (2 ** 32))
    k = w / REF_WIDTH
    img = _background(rng, h, w)
    objects = []
    occupied = np.zeros((h, w), bool)
    for _ in range(rng.randint(lo, hi + 1)):
        for _attempt in range(10):
            bw = rng.randint(max(8, int(40 * k)), max(9, min(int(200 * k), w // 3)))
            bh = rng.randint(max(8, int(32 * k)), max(9, min(int(160 * k), h // 3)))
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(h // 6, h - bh)
            if occupied[y1:y1 + bh, x1:x1 + bw].mean() < 0.3:
                break
        cls = classes[rng.randint(len(classes))]
        _draw_object(rng, img, cls, (x1, y1, x1 + bw, y1 + bh))
        occupied[y1:y1 + bh, x1:x1 + bw] = True
        objects.append((cls, (x1, y1, x1 + bw, y1 + bh)))
    if foggy:
        img = _foggify(rng, img)
    fid = f"{i:06d}"
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        os.path.join(root, "JPEGImages", fid + ".jpg"), quality=quality)
    _write_xml(os.path.join(root, "Annotations", fid + ".xml"), w, h, objects)
    return fid


def tree_spec(dataset: Dict, count: int, scale: str, seed: int, short: int, max_size: int,
              quality: int) -> Dict:
    """Everything that decides a tree's files."""
    return {"hw": list(stored_hw(dataset["hw"], scale, short, max_size)),
            "classes": list(dataset["class_names"]), "boxes": list(dataset["boxes_per_image"]),
            "foggy": bool(dataset["foggy"]), "count": int(count), "seed": int(seed),
            "quality": int(quality)}


def ensure_tree(cache: str, spec: Dict, workers: int) -> str:
    """The tree of ``spec`` under ``cache``, written first if it is not there.

    Its directory is named by a hash of the spec, so runs that need the same files
    share them; a tree is written into a ``.partial`` directory and renamed when
    complete, so a run that was cut leaves nothing that a later run would take."""
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    root = os.path.join(cache, f"tree-{key}")
    if os.path.exists(os.path.join(root, "ImageSets", "Main", "train.txt")):
        return root
    part = root + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(part, d), exist_ok=True)
    jobs = [(part, i, spec["seed"], tuple(spec["hw"]), tuple(spec["classes"]),
             tuple(spec["boxes"]), spec["foggy"], spec["quality"]) for i in range(spec["count"])]
    if workers > 1 and spec["count"] >= 64:   # a pool only where it pays for its start
        with mp.get_context("spawn").Pool(workers) as pool:
            ids: List[str] = pool.map(_scene, jobs, chunksize=8)
    else:
        ids = [_scene(j) for j in jobs]
    with open(os.path.join(part, "ImageSets", "Main", "train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    with open(os.path.join(part, "spec.json"), "w") as f:
        json.dump(spec, f, sort_keys=True)
    shutil.rmtree(root, ignore_errors=True)
    os.rename(part, root)
    return root
