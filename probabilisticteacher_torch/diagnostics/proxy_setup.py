"""The setup the two proxy diagnostics share (the port of ``scripts/_proxy_common.py``).

:func:`load_proxy_setup` gives ``diagnose_levers`` and ``diagnose_student_path`` the
same config, images and weights, so the two can never disagree on the proxy's
overrides, the canvas filter or which checkpoint slot holds the converged model:

- the recipe ``configs/pt/final_c2f.yaml`` with the JAX setup's overrides (TAU
  [0.5, 0.5], learnable anchors, no VGG pretrain, ``short`` px inputs on a
  ``(short, short * 992 // 480)`` canvas, AMP off), then any trailing ``KEY VALUE``
  overrides (``SOLVER.AMP.ENABLED True`` runs the pass in bf16, as training does);
- the first ``n`` foggy-train records whose mapped image fills the wide canvas (and
  has ground truth, with ``require_gt``), mapped by the port's ``Mapper`` with
  ``np.random.default_rng(0)``: the images the JAX scripts read;
- the STUDENT slot of a port checkpoint, read through ``checkpoint.load_weights``. A
  source-only checkpoint's teacher slot is still at its init (burn-in never updates
  it; the boundary copy happens when mutual learning starts), so the converged model
  is the student, which mutual learning copies into the teacher at ``BURN_UP_STEP``.
  ``--slot teacher`` reads the EMA teacher of a mutual-learning checkpoint instead,
  the model whose weak pass gives training its pseudo boxes.

The pass runs on the card unless ``device`` is ``"cpu"``; asked for the card with
none present, it raises. On the card TF32 is turned off for the process, so that f32
is f32, as on the JAX scripts' CPU (under AMP the convolutions run in bf16 either
way).
"""

from __future__ import annotations

import argparse
import os
import types
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..accuracy_proxy import RECIPE, WORK
from ..checkpoint import load_weights
from ..config import Arch, CfgNode, get_cfg
from ..data.datasets import CLASS_NAMES_8, load_voc_instances
from ..data.loader import Mapper
from ..modeling.detector import PTDetector
from ..structures import ImageBatch, resolve_device

# the accuracy proxy's data and its stage 1's final checkpoint (the port's
# counterparts of the JAX scripts' .proxy_data and .proxy_runs/source_only)
DEFAULT_DATA = os.path.join(WORK, "data")
DEFAULT_WEIGHTS = os.path.join(WORK, "source_only", "model_0003000")


def proxy_cfg(short: int, opts: Sequence[str] = ()) -> CfgNode:
    """The recipe with the JAX setup's overrides (``_proxy_common.py:42-50``), then
    ``opts``."""
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list([
        "UNSUPNET.TAU", "[0.5,0.5]",
        "MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
        "MODEL.VGG.PRETRAIN", "",
        "INPUT.MIN_SIZE_TRAIN", f"({short},)",
        "INPUT.CANVAS.WIDE", f"({short}, {short * 992 // 480})",
        "INPUT.CANVAS.TALL", f"({short * 992 // 480}, {short})",
        "SOLVER.AMP.ENABLED", "False",
    ] + list(opts))
    return cfg


def proxy_records(cfg, n: int, short: int, data_root: str,
                  require_gt: bool = False) -> List[dict]:
    """The first ``n`` mapped foggy-train records on the wide canvas."""
    canvas = (short, short * 992 // 480)
    records = load_voc_instances(os.path.join(data_root, "data", "VOC2007_foggytrain"), "train",
                                 CLASS_NAMES_8)
    mapper = Mapper(cfg, is_train=True)
    rng = np.random.default_rng(0)
    imgs = []
    for rec in records:
        out = mapper(rec, rng)
        if out["image"].shape[:2] == canvas and (
                not require_gt or int(out["gt_valid"].sum()) > 0):
            imgs.append(out)
        if len(imgs) == n:
            break
    if len(imgs) != n:
        raise ValueError(f"only {len(imgs)} usable wide-canvas records in {data_root}")
    return imgs


def load_slot(weights: str, arch: Arch, device: torch.device,
              slot: str = "student") -> PTDetector:
    """A detector holding the ``slot`` ("student" or "teacher") of the port checkpoint
    ``weights``."""
    det = PTDetector(arch, device=device)
    if slot == "student":
        load_weights(weights, types.SimpleNamespace(student=det), student_only=True)
    elif slot == "teacher":   # both slots go into ``det``, the teacher's last
        load_weights(weights, types.SimpleNamespace(student=det, teacher=det))
    else:
        raise ValueError(f"checkpoint slot {slot!r} is neither student nor teacher")
    return det.requires_grad_(False)


def load_proxy_setup(n: int, short: int, data_root: str, weights: str,
                     require_gt: bool = False, device=None, opts: Sequence[str] = (),
                     slot: str = "student"
                     ) -> Tuple[CfgNode, Arch, PTDetector, ImageBatch, List[dict]]:
    """Returns (cfg, base_arch, model, batch, mapped records): the model holds the
    checkpoint's ``slot`` (the student unless told otherwise); it and the batch are on
    ``device`` (the card unless it is ``"cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = proxy_cfg(short, opts)
    imgs = proxy_records(cfg, n, short, data_root, require_gt)
    batch = ImageBatch(
        image=torch.from_numpy(np.stack([o["image"] for o in imgs]).astype(np.float32)).to(dev),
        image_hw=torch.from_numpy(np.stack([o["image_hw"] for o in imgs])).to(dev))
    base_arch = Arch.from_cfg(cfg)
    return cfg, base_arch, load_slot(weights, base_arch, dev, slot), batch, imgs


def build_parser(description: str) -> argparse.ArgumentParser:
    """The JAX scripts' flags (``--n``, ``--short``, ``--data``, ``--weights``), then
    ``--slot``, ``--device`` and trailing ``KEY VALUE`` config overrides."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--short", type=int, default=480)
    p.add_argument("--data", default=DEFAULT_DATA,
                   help="the proxy's root, as scripts/make_daod_proxy.py --root wrote it")
    p.add_argument("--weights", default=DEFAULT_WEIGHTS,
                   help="a port checkpoint (model_NNNNNNN); its student slot is read")
    p.add_argument("--slot", default="student", choices=["student", "teacher"],
                   help="the checkpoint's model to read (the teacher of a mutual-learning "
                        "checkpoint gives training's pseudo boxes)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE config overrides, e.g. SOLVER.AMP.ENABLED True")
    return p

