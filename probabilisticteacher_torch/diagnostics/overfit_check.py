"""Learning-dynamics check: overfit a tiny synthetic VOC set and watch mAP rise (the
port of ``scripts/overfit_check.py``).

    python -m probabilisticteacher_torch.diagnostics.overfit_check [--iters 150]
        [--burnup 120] [--device cuda|cpu] [--amp] [--danchor] [--nms greedy|maxpool]

Checks the whole loop (data -> burn-in -> mutual learning -> eval) beyond a smoke
test: VGG-11 on 4 labeled and 4 unlabeled 96 x 144 images with 3 classes of bright
rectangles (``tests/synthetic_data.py::make_voc_dataset``), through the port's
``PTrainer``. The student's train-set mAP50 is read before training, then the
student's and the teacher's after it; the student must clear ``max(before + 10,
20)``, or 10 under ``--amp`` (bf16 from scratch learns more slowly at this scale),
or the run exits non-zero. Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import tempfile
from typing import Optional, Sequence

from ..config import CfgNode, get_cfg
from ..data.datasets import register_pascal_voc
from ..structures import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNTHETIC_DATA = os.path.join(REPO, "tests", "synthetic_data.py")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--burnup", type=int, default=120)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--amp", action="store_true", help="bf16 compute (the recipe's numeric path)")
    p.add_argument("--danchor", action="store_true",
                   help="learnable anchors (anchor adaptation)")
    p.add_argument("--nms", default="greedy", choices=["greedy", "maxpool"],
                   help="train-proposal NMS impl (mAP-neutrality check for maxpool)")
    return p


def synthetic_data():
    """The repo's synthetic VOC writer, ``tests/synthetic_data.py`` (numpy and PIL)."""
    spec = importlib.util.spec_from_file_location("_pt_synthetic_data", SYNTHETIC_DATA)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def overfit_cfg(args, root: str) -> CfgNode:
    """Every override of ``scripts/overfit_check.py:51-94``, with ``args.device`` as
    ``MODEL.DEVICE``."""
    cfg = get_cfg()
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    cfg.MODEL.DEVICE = args.device
    cfg.MODEL.VGG.DEPTH = 11
    cfg.MODEL.VGG.PRETRAIN = ""
    # objects are 12-48 px; the default 128-512 anchors would never reach IoU 0.3
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = ((16, 32, 64),)
    if args.danchor:
        cfg.MODEL.ANCHOR_GENERATOR.NAME = "DifferentiableAnchorGenerator"
        cfg.MODEL.ANCHOR_GENERATOR.ANCHOR = (((16.0, 16.0), (32.0, 32.0), (64.0, 64.0),
                                              (12.0, 24.0), (24.0, 48.0), (48.0, 96.0),
                                              (24.0, 12.0), (48.0, 24.0), (96.0, 48.0)),)
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.RPN.NMS_IMPL = args.nms
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.UNSUPNET.UNSUP_ROI_BUDGET = 16
    cfg.UNSUPNET.BURN_UP_STEP = args.burnup
    cfg.UNSUPNET.EMA_KEEP_RATE = 0.9
    cfg.SOLVER.MAX_ITER = args.iters
    cfg.SOLVER.IMG_PER_BATCH_LABEL = 4
    cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 4
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 10
    cfg.SOLVER.STEPS = (10_000,)
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.SOLVER.AMP.ENABLED = bool(args.amp)
    cfg.TEST.EVAL_PERIOD = 0
    cfg.TEST.EVALUATOR = "VOCeval"
    cfg.INPUT.MIN_SIZE_TRAIN = (96,)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.INPUT.CANVAS.WIDE = (96, 160)
    cfg.INPUT.CANVAS.TALL = (160, 96)
    cfg.INPUT.MAX_GT = 8
    cfg.DATASETS.TRAIN_LABEL = ("ov_l",)
    cfg.DATASETS.TRAIN_UNLABEL = ("ov_u",)
    cfg.DATASETS.TEST = ("ov_l",)
    return cfg


def write_data(root: str) -> None:
    """The two toy splits of the JAX script, registered as ``ov_l`` and ``ov_u``."""
    sd = synthetic_data()
    sd.make_voc_dataset(os.path.join(root, "src"), "train", num_images=4, hw=(96, 144),
                        num_classes=3, seed=0, boxes_per_image=2)
    sd.make_voc_dataset(os.path.join(root, "tgt"), "train", num_images=4, hw=(96, 144),
                        num_classes=3, seed=1, boxes_per_image=2)
    register_pascal_voc("ov_l", os.path.join(root, "src"), "train", sd.CLASSES)
    register_pascal_voc("ov_u", os.path.join(root, "tgt"), "train", sd.CLASSES)


def run(args) -> dict:
    """Train and evaluate; returns the mAP50 readings and the bar, printed as the JAX
    script prints them. The bar is not applied here (:func:`check_bar`)."""
    from ..engine.trainer import PTrainer

    resolve_device("cpu" if args.device == "cpu" else None)   # no card: raise before writing
    root = tempfile.mkdtemp(prefix="overfit_")
    try:
        write_data(root)
        trainer = PTrainer(overfit_cfg(args, root))
        before = trainer.test(trainer.state.student)["mAP50"]
        print(f"mAP50 before training: {before:.2f}", flush=True)
        trainer.train()
        after_student = trainer.test(trainer.state.student)["mAP50"]
        after_teacher = trainer.test(trainer.state.teacher)["mAP50"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"mAP50 after {args.iters} iters: student={after_student:.2f} "
          f"teacher={after_teacher:.2f}", flush=True)
    # bf16 from-scratch training converges more slowly at toy scale; the bar is
    # "clearly learning", not a fixed accuracy
    bar = 10 if args.amp else max(before + 10, 20)
    return {"before": before, "student": after_student, "teacher": after_teacher, "bar": bar}


def check_bar(res: dict) -> None:
    """Exit non-zero unless the student cleared the bar."""
    if not res["student"] > res["bar"]:
        raise SystemExit(f"model failed to overfit: {res['before']:.2f} -> "
                         f"{res['student']:.2f} (bar {res['bar']})")
    print("OVERFIT CHECK PASSED", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    check_bar(run(build_parser().parse_args(argv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
