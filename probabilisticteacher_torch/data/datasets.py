"""Dataset catalog + VOC/COCO loaders (host side, numpy only).

Mirrors the reference's registry surface (``pt/data/datasets/builtin.py:41-154``):
the same nine VOC-format splits under $DETECTRON2_DATASETS, the COCO-unlabeled
entries, and the same class lists. Loaders return detectron2-style dataset dicts:
{"file_name", "image_id", "height", "width", "annotations":
 [{"bbox": XYXY, "category_id": int}]}.

COCO json is parsed with the stdlib (no pycocotools dependency for loading).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence


class _Catalog:
    def __init__(self):
        self._fns: Dict[str, Callable[[], List[dict]]] = {}
        self.metadata: Dict[str, dict] = {}

    def register(self, name: str, fn: Callable[[], List[dict]], **meta) -> None:
        self._fns[name] = fn
        self.metadata[name] = meta

    def get(self, name: str) -> List[dict]:
        if name not in self._fns:
            raise KeyError(f"Dataset '{name}' is not registered. Known: {sorted(self._fns)}")
        return self._fns[name]()

    def has(self, name: str) -> bool:
        return name in self._fns

    def class_names(self, name: str) -> Optional[Sequence[str]]:
        return self.metadata.get(name, {}).get("class_names")


DatasetCatalog = _Catalog()

CLASS_NAMES_8 = ("truck", "car", "rider", "person", "train", "motorcycle", "bicycle", "bus")
CLASS_NAMES_1 = ("car",)
CLASS_NAMES_20 = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str, class_names: Sequence[str]) -> List[dict]:
    """detectron2 ``load_voc_instances`` semantics: x1/y1 get -1 (VOC is 1-indexed)."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]

    dicts = []
    name_to_id = {n: i for i, n in enumerate(class_names)}
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        if not os.path.exists(jpeg_file):
            png = jpeg_file[:-4] + ".png"
            if os.path.exists(png):
                jpeg_file = png
        tree = ET.parse(anno_file)
        r = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(float(tree.findall("./size/height")[0].text)),
            "width": int(float(tree.findall("./size/width")[0].text)),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in name_to_id:
                continue
            difficult = obj.find("difficult")
            difficult = int(difficult.text) if difficult is not None else 0
            bbox = obj.find("bndbox")
            coords = [float(bbox.find(t).text) for t in ("xmin", "ymin", "xmax", "ymax")]
            coords[0] -= 1.0
            coords[1] -= 1.0
            instances.append({
                "category_id": name_to_id[cls],
                "bbox": coords,
                "difficult": difficult,
            })
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def load_coco_json(json_file: str, image_root: str,
                   unlabeled: bool = False) -> List[dict]:
    """Minimal COCO-format loader (stdlib json; images-only when ``unlabeled``)."""
    with open(json_file) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    anns_per_img: Dict[int, List[dict]] = {}
    if not unlabeled:
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            anns_per_img.setdefault(ann["image_id"], []).append(ann)
    dicts = []
    for img in sorted(coco["images"], key=lambda x: x["id"]):
        r = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "annotations": [],
        }
        for ann in anns_per_img.get(img["id"], []):
            x, y, w, h = ann["bbox"]  # COCO XYWH -> XYXY
            r["annotations"].append({
                "category_id": id_map[ann["category_id"]],
                "bbox": [x, y, x + w, y + h],
                "difficult": 0,
            })
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str,
                        class_names: Sequence[str]) -> None:
    DatasetCatalog.register(
        name, lambda: load_voc_instances(dirname, split, class_names),
        class_names=tuple(class_names), evaluator_type="pascal_voc", dirname=dirname,
        split=split,
    )


def register_coco_instances(name: str, json_file: str, image_root: str,
                            class_names: Sequence[str] = (), unlabeled: bool = False) -> None:
    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, unlabeled),
        class_names=tuple(class_names), evaluator_type="coco", json_file=json_file,
    )


def register_builtin(root: Optional[str] = None) -> None:
    """The reference's builtin table (``builtin.py:120-154``), idempotent."""
    root = root if root is not None else os.getenv("DETECTRON2_DATASETS", "")
    SPLITS = [
        ("VOC2007_citytrain", "data/VOC2007_citytrain", "train", CLASS_NAMES_8),
        ("VOC2007_foggytrain", "data/VOC2007_foggytrain", "train", CLASS_NAMES_8),
        ("VOC2007_foggyval", "data/VOC2007_foggyval", "val", CLASS_NAMES_8),
        # not in the reference's table (builtin.py:120-154); used by the
        # source-domain no-gap control in REPORT_accuracy.md
        ("VOC2007_cityval", "data/VOC2007_cityval", "val", CLASS_NAMES_8),
        ("VOC2007_citytrain1", "data/VOC2007_citytrain1", "train", CLASS_NAMES_1),
        ("VOC2007_cityval1", "data/VOC2007_cityval1", "val", CLASS_NAMES_1),
        ("VOC2007_bddtrain", "data/VOC2007_bddtrain", "train", CLASS_NAMES_8),
        ("VOC2007_bddval", "data/VOC2007_bddval", "val", CLASS_NAMES_8),
        ("VOC2007_kitti1", "data/kitti", "train", CLASS_NAMES_1),
        ("VOC2007_sim1", "data/sim", "train", CLASS_NAMES_1),
    ]
    for name, dirname, split, class_names in SPLITS:
        if not DatasetCatalog.has(name):
            register_pascal_voc(name, os.path.join(root, dirname), split, class_names)
    if not DatasetCatalog.has("coco_2017_unlabel"):
        register_coco_instances(
            "coco_2017_unlabel",
            os.path.join(root, "coco/annotations/image_info_unlabeled2017.json"),
            os.path.join(root, "coco/unlabeled2017"),
            unlabeled=True,
        )
