"""A tiny cell, added as data to a copy of ``benchmark/``, that the CPU tests run end
to end: VGG-11 on a 64 x 128 canvas, 2 + 2 images, small budgets, f32 or bf16."""

from __future__ import annotations

import json
import os
import shutil
from typing import Tuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

# program config key -> (group, key) of the configuration file, with its tiny value
TINY = [
    ("MODEL.VGG.DEPTH", "arch", "vgg_depth", 11),
    ("MODEL.RPN.PRE_NMS_TOPK_TRAIN", None, None, 96),
    ("MODEL.RPN.PRE_NMS_TOPK_TEST", None, None, 48),
    ("MODEL.RPN.POST_NMS_TOPK_TRAIN", None, None, 40),
    ("MODEL.RPN.POST_NMS_TOPK_TEST", None, None, 24),
    ("MODEL.RPN.BATCH_SIZE_PER_IMAGE", "arch", "rpn_batch_per_image", 32),
    ("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "arch", "roi_batch_per_image", 16),
    ("MODEL.ROI_BOX_HEAD.FC_DIM", "arch", "fc_dim", 64),
    ("TEST.DETECTIONS_PER_IMAGE", "arch", "detections_per_image", 12),
    ("UNSUPNET.UNSUP_ROI_BUDGET", "arch", "unsup_roi_budget", 16),
    ("UNSUPNET.BURN_UP_STEP", "train", "burn_up_step", 6),
    ("SOLVER.IMG_PER_BATCH_LABEL", "train", "img_per_batch_label", 2),
    ("SOLVER.IMG_PER_BATCH_UNLABEL", "train", "img_per_batch_unlabel", 2),
    ("SOLVER.REFERENCE_BATCH_SIZE", None, None, 0),
    ("SOLVER.WARMUP_ITERS", "solver", "warmup_iters", 2),
    ("INPUT.MIN_SIZE_TRAIN", "input", "min_size_train", [64]),
    ("INPUT.MAX_SIZE_TRAIN", "input", "max_size_train", 128),
    ("INPUT.CANVAS.WIDE", "input", "canvas_wide", [64, 128]),
    ("INPUT.CANVAS.TALL", "input", "canvas_tall", [128, 64]),
    ("INPUT.MAX_GT", "input", "max_gt", 12),
]


def _cfg_value(v) -> str:
    return repr(tuple(v)) if isinstance(v, list) else str(v)


def tiny_config(base: str = "pt_vgg16_c2f", amp: bool = True, phase: str = "mutual",
                native: bool = True) -> dict:
    """The configuration file of the tiny cell, from the recipe's; burn-in runs far
    below BURN_UP_STEP. ``native`` False decodes with PIL alone."""
    with open(os.path.join(BENCH, "configs", base + ".json")) as f:
        c = json.load(f)
    c["name"] = "tiny_" + base
    over = list(c["overrides"])
    for key, group, k, v in TINY:
        over += [key, _cfg_value(v)]
        if group:
            c[group][k] = v
    c["arch"]["rpn_pre_nms_topk"] = [48, 96]
    c["arch"]["rpn_post_nms_topk"] = [24, 40]
    if phase == "burnin":
        over += ["UNSUPNET.BURN_UP_STEP", "100000"]
        c["train"]["burn_up_step"] = 100000
    if not native:
        over += ["DATALOADER.NATIVE", "False"]
    if not amp:
        over += ["SOLVER.AMP.ENABLED", "False"]
        c["precision"] = "float32"
    c["overrides"] = over
    for s in ("label", "unlabel"):
        c["datasets"][s]["hw"] = [96, 192]
        c["datasets"][s]["boxes_per_image"] = [1, 6]
    c["label_images"] = c["unlabel_images"] = 12
    return c


def add_tiny_cell(dest: str, phase: str = "mutual", amp: bool = True,
                  limits: dict = None, base: str = "pt_vgg16_c2f",
                  native: bool = True) -> Tuple[str, str]:
    """Copy ``benchmark/`` and BENCHMARK.json into ``dest`` and add a tiny cell there by
    data alone: a configuration file, a traffic file, a limits file and an entry.
    Returns (path of the copied BENCHMARK.json, workload name)."""
    bdir = os.path.join(dest, "benchmark")
    shutil.copytree(BENCH, bdir, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cfg = tiny_config(base, amp, phase, native)
    with open(os.path.join(bdir, "configs", cfg["name"] + ".json"), "w") as f:
        json.dump(cfg, f)
    traffic = {"name": f"tiny_{phase}", "phase": phase,
               "start_iter": "burn_up" if phase == "mutual" else 2, "stored_scale": "native",
               "format": "jpeg", "jpeg_quality": 90, "tree_seed": 7}
    with open(os.path.join(bdir, "traffic", traffic["name"] + ".json"), "w") as f:
        json.dump(traffic, f)
    name = f"tiny_{phase}_{'bf16' if amp else 'f32'}"
    # f32 with PIL decoding reproduces the reference to rounding
    lim = limits or {"batch": 2, "loss": 1e-5, "rpn_first": 1e-5, "rpn_out_first": 1e-5,
                     "grad": 1e-3, "delta": 1e-3, "delta_median": 1e-3}
    if phase == "mutual" and not limits:
        lim.update(pseudo_miss=0.0, teacher_delta=1e-3)
    with open(os.path.join(bdir, "limits", name + ".json"), "w") as f:
        json.dump(lim, f)
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"],
                            "file": f"benchmark/configs/{cfg['name']}.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": name, "config": cfg["name"], "traffic": traffic["name"],
                              "chips": 1, "why": "tiny"})
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path, name


# a second architecture, as the files a later configuration brings: a reference
# module and a count module under new names that record their use
MARKED_REFERENCE = '''"""The VGG16 reference under another name, standing in for a second architecture's
reference in the harness's tests: it counts the detectors it builds."""
from .vgg16 import (Arch, GroundTruth, ImageBatch, build_state, burnin_step, exact,
                    fp8_e4m3, mutual_step)
from .vgg16 import Detector as VGG16Detector

BUILT = []


class Detector(VGG16Detector):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        BUILT.append(type(self).__name__)
'''

MARKED_COUNTS = '''"""Work counts standing in for a second architecture's in the harness's tests: three
times the VGG16 model FLOPs, and K1/K2 launches whose least times are twice the
VGG16 ones."""
from . import counts

CALLS = []
FLOPS_FACTOR = 3
BOUND_FACTOR = 2


def iteration_flops(arch, phase, n_l, n_u, hw_l, hw_u):
    CALLS.append("iteration_flops")
    return {k: FLOPS_FACTOR * v
            for k, v in counts.iteration_flops(arch, phase, n_l, n_u, hw_l, hw_u).items()}


def kernel_launches(arch, phase, n_l, n_u, canvas):
    CALLS.append("kernel_launches")
    return {k: [BOUND_FACTOR * t for t in v]
            for k, v in counts.kernel_launches(arch, phase, n_l, n_u, canvas).items()}
'''


def add_tiny_architecture(dest: str, cell: str, name: str = "tiny_marked") -> str:
    """Add to the copy at ``dest`` (made by :func:`add_tiny_cell`) a configuration that
    names its own reference module (``reference/<name>.py``) and count module
    (``harness/<name>_counts.py``), with a limits file and a workload entry, by new
    files and new entries alone. The configuration is the tiny cell ``cell``'s.
    Returns the new workload's name."""
    bdir = os.path.join(dest, "benchmark")
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    with open(os.path.join(bdir, "configs", w["config"] + ".json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, reference=name, counts=name + "_counts")
    files = {os.path.join("reference", name + ".py"): MARKED_REFERENCE,
             os.path.join("harness", name + "_counts.py"): MARKED_COUNTS,
             os.path.join("configs", name + ".json"): json.dumps(cfg)}
    with open(os.path.join(bdir, "limits", cell + ".json")) as f:
        files[os.path.join("limits", name + "_cell.json")] = f.read()
    for rel, text in files.items():
        assert not os.path.exists(os.path.join(bdir, rel)), rel
        with open(os.path.join(bdir, rel), "w") as f:
            f.write(text)
    spec["configs"].append({"name": name, "source": cfg["source"],
                            "file": f"benchmark/configs/{name}.json", "reduced": [],
                            "why": "a second architecture's files"})
    spec["workloads"].append(dict(w, name=name + "_cell", config=name))
    with open(path, "w") as f:
        json.dump(spec, f)
    return name + "_cell"
