"""Shared micro-scale setup for the port's host-side tests (data, eval, trainer, CLI).

``micro_opts`` is the ``KEY VALUE`` list of ``tests/test_e2e.py::micro_cfg`` (VGG-11,
canvas 48 x 96, tiny proposal and sampling budgets, f32), usable both with
``cfg.merge_from_list`` on either package's config and on the port's command line.
``voc_tree`` writes the synthetic VOC trees of ``tests/synthetic_data.py``.
"""

import os

from synthetic_data import make_voc_dataset


def micro_opts(output_dir, label, unlabel, test, max_iter=4, burn_up=2, device="cpu"):
    return [
        "MODEL.DEVICE", device,
        "OUTPUT_DIR", str(output_dir),
        "MODEL.VGG.DEPTH", "11",
        "MODEL.VGG.PRETRAIN", "",
        "MODEL.ROI_HEADS.NUM_CLASSES", "8",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
        "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
        "MODEL.ROI_BOX_HEAD.FC_DIM", "32",
        "TEST.DETECTIONS_PER_IMAGE", "8",
        "UNSUPNET.UNSUP_ROI_BUDGET", "8",
        "UNSUPNET.BURN_UP_STEP", str(burn_up),
        "UNSUPNET.EMA_KEEP_RATE", "0.5",
        "SOLVER.MAX_ITER", str(max_iter),
        "SOLVER.IMG_PER_BATCH_LABEL", "2",
        "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
        "SOLVER.REFERENCE_BATCH_SIZE", "0",
        "SOLVER.BASE_LR", "0.001",
        "SOLVER.CHECKPOINT_PERIOD", "2",
        "SOLVER.AMP.ENABLED", "False",
        "TEST.EVAL_PERIOD", "4",
        "TEST.EVALUATOR", "VOCeval",
        "INPUT.MIN_SIZE_TRAIN", "(48,)",
        "INPUT.MAX_SIZE_TRAIN", "96",
        "INPUT.MIN_SIZE_TEST", "48",
        "INPUT.MAX_SIZE_TEST", "96",
        "INPUT.CANVAS.WIDE", "(48, 96)",
        "INPUT.CANVAS.TALL", "(96, 48)",
        "INPUT.MAX_GT", "8",
        "DATASETS.TRAIN_LABEL", f"('{label}',)",
        "DATASETS.TRAIN_UNLABEL", f"('{unlabel}',)",
        "DATASETS.TEST", f"('{test}',)",
    ]


def voc_tree(root):
    """Labeled (src), unlabeled (tgt) and val trees; returns ``root``."""
    make_voc_dataset(os.path.join(root, "src"), "train", num_images=4, seed=0)
    make_voc_dataset(os.path.join(root, "tgt"), "train", num_images=4, seed=1)
    make_voc_dataset(os.path.join(root, "val"), "val", num_images=3, seed=2)
    return root


def register_both(register_jax, register_torch, prefix, root, classes):
    """Register the three trees under ``prefix_{l,u,v}`` in both catalogs."""
    for reg in (register_jax, register_torch):
        reg(prefix + "_l", os.path.join(root, "src"), "train", classes)
        reg(prefix + "_u", os.path.join(root, "tgt"), "train", classes)
        reg(prefix + "_v", os.path.join(root, "val"), "val", classes)
    return prefix + "_l", prefix + "_u", prefix + "_v"
