"""Import detectron2/reference-format checkpoints (.pth / .pkl) into the port's models.

The reference evaluates its published results by loading torch-format
checkpoints through ``MODEL.WEIGHTS`` with ``--eval-only``: a
``DetectionTSCheckpointer`` restores an ``EnsembleTSModel`` state_dict
(``modelTeacher.* + modelStudent.*``) or, for plain detector checkpoints, a
student-only name-matched load with shape-mismatch skipping
(``pt/checkpoint/detection_checkpoint.py:24-103``).

This module maps detectron2 names onto :class:`PTDetector`'s ``state_dict``.
The port keeps torch's layouts, so only ``fc1`` is rearranged:

=============================================  =============================  ==========================
detectron2 name (student scope)                port name                      layout conversion
=============================================  =============================  ==========================
``backbone.vgg_blockB.0.convC.*``              ``backbone.blockB_convC.*``    none (OIHW both)
``proposal_generator.rpn_head.conv.*``         ``rpn_head.conv.*``            none
``proposal_generator.rpn_head.                 ``rpn_head.objectness.*``      none
  objectness_logits.*``
``proposal_generator.rpn_head.                 ``rpn_head.deltas.*``          none (A*8 channel order
  anchor_deltas.*``                                                           a*8+b, ``rpn.py:105-113``)
``roi_heads.box_head.fc1.weight``              ``box_head.fc1.weight``        (F, C*P*P) CHW flatten ->
                                                                              (F, P*P*C) HWC flatten
``roi_heads.box_head.fc2.*``                   ``box_head.fc2.*``             none
``roi_heads.box_predictor.cls_score.*``        ``predictor.cls_score.*``      none
``roi_heads.box_predictor.bbox_pred.*``        ``predictor.bbox_pred.*``      none (K blocks of
                                                                              [4 mean, 4 sigma])
``proposal_generator.anchor_generator.         ``anchor_wh``                  none ((A, 2) w/h table,
  anchor_0``                                                                  ``anchor_generator.py:69``)
=============================================  =============================  ==========================

``pixel_mean`` / ``pixel_std`` and ``anchor_generator.cell_anchors*`` are ignored
(config-derived here, as the reference ignores them,
``detection_checkpoint.py:41-49``). Keys whose shape does not match the model are
skipped with a warning (fvcore semantics, ``detection_checkpoint.py:87-94``).
Caffe2-author ``.pkl`` files with raw Caffe2 layer names are not handled; use
``checkpoint.load_vgg_caffe`` for the published VGG backbone init.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("probabilisticteacher_torch")

# flat numpy state dict: d2 name -> array
StateDict = Dict[str, np.ndarray]

_IGNORED = re.compile(
    r"^(pixel_mean|pixel_std|proposal_generator\.anchor_generator\.cell_anchors.*)$"
)


def read_checkpoint_file(path: str) -> StateDict:
    """Read a torch ``.pth`` or detectron2 ``.pkl`` into a flat numpy dict.

    Accepts the wrapper layouts the reference's checkpointer sees: a raw
    state_dict, ``{"model": state_dict, ...}`` (fvcore save format; extra keys
    like optimizer/scheduler/iteration are dropped), torch tensors or numpy
    arrays as values. Like the reference's loader, this unpickles the file: load
    only checkpoints you trust.
    """
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        if isinstance(data, dict) and data.get("__author__") == "Caffe2":
            raise ValueError(
                f"{path} is a Caffe2-format checkpoint with Caffe2 layer names; "
                "only detectron2-named checkpoints are supported here "
                "(use checkpoint.load_vgg_caffe for the VGG backbone init)")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "model" in data and isinstance(data["model"], dict):
        data = data["model"]
    if not isinstance(data, dict):
        raise ValueError(f"{path}: unsupported checkpoint structure {type(data)}")
    out: StateDict = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            out[k] = v
    return out


def split_ensemble(sd: StateDict) -> Tuple[Optional[StateDict], Optional[StateDict]]:
    """Split an EnsembleTSModel state_dict into (student, teacher) scopes.

    Returns (sd, None) when the dict is a plain single-model state_dict.
    ``module.`` DDP prefixes are stripped first (the reference strips them in
    ``_load_student_model``, ``detection_checkpoint.py:83``).
    """
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    student = {k[len("modelStudent."):]: v for k, v in sd.items()
               if k.startswith("modelStudent.")}
    teacher = {k[len("modelTeacher."):]: v for k, v in sd.items()
               if k.startswith("modelTeacher.")}
    if student or teacher:
        return (student or None), (teacher or None)
    return sd, None


def _fc1_weight(arr: np.ndarray, pooler_resolution: int) -> np.ndarray:
    """torch Linear weight (F, C*P*P) over a channel-first flatten -> the port's
    ``fc1`` weight (F, P*P*C) over the HWC flatten of the pooled block."""
    f = arr.shape[0]
    p = pooler_resolution
    c = arr.shape[1] // (p * p)
    return np.ascontiguousarray(arr.reshape(f, c, p, p).transpose(0, 2, 3, 1).reshape(f, -1))


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _route(key: str, pooler_resolution: int) -> Optional[Tuple[str, Callable]]:
    """d2 state_dict key -> (port state_dict key, conversion fn), or None."""
    m = re.fullmatch(r"backbone\.vgg_block(\d+)\.0\.conv(\d+)\.(weight|bias)", key)
    if m:
        return f"backbone.block{m.group(1)}_conv{m.group(2)}.{m.group(3)}", _same
    m = re.fullmatch(
        r"proposal_generator\.rpn_head\.(conv|objectness_logits|anchor_deltas)\.(weight|bias)",
        key)
    if m:
        name = {"conv": "conv", "objectness_logits": "objectness",
                "anchor_deltas": "deltas"}[m.group(1)]
        return f"rpn_head.{name}.{m.group(2)}", _same
    m = re.fullmatch(r"roi_heads\.box_head\.fc(\d+)\.(weight|bias)", key)
    if m:
        i, kind = m.group(1), m.group(2)
        if i == "1" and kind == "weight":
            return "box_head.fc1.weight", lambda a: _fc1_weight(a, pooler_resolution)
        return f"box_head.fc{i}.{kind}", _same
    m = re.fullmatch(r"roi_heads\.box_predictor\.(cls_score|bbox_pred)\.(weight|bias)", key)
    if m:
        return f"predictor.{m.group(1)}.{m.group(2)}", _same
    if key == "proposal_generator.anchor_generator.anchor_0":
        return "anchor_wh", _same
    return None


def d2_to_params(sd: StateDict, state_dict: Mapping[str, torch.Tensor],
                 pooler_resolution: int = 7) -> Tuple[Dict[str, torch.Tensor], Dict[str, List]]:
    """Map a detectron2-named flat state_dict onto a copy of the port's ``state_dict``.

    Returns ``(new_state_dict, report)`` where report lists ``matched``,
    ``missing`` (model keys not found in the checkpoint), ``unexpected``
    (checkpoint keys with no model target), and ``incorrect_shapes``
    (skipped, keeping the model's tensor: fvcore parity).
    """
    new = dict(state_dict)
    matched: List[str] = []
    unexpected: List[str] = []
    incorrect: List[Tuple[str, tuple, tuple]] = []
    filled = set()

    for key, arr in sd.items():
        if _IGNORED.match(key):
            continue
        target = _route(key, pooler_resolution)
        if target is None or target[0] not in state_dict:
            unexpected.append(key)
            continue
        name, convert = target
        ref = state_dict[name]
        conv = convert(np.asarray(arr))
        if tuple(ref.shape) != tuple(conv.shape):
            incorrect.append((key, tuple(conv.shape), tuple(ref.shape)))
            continue
        new[name] = torch.from_numpy(np.ascontiguousarray(conv)).to(ref.device, ref.dtype)
        matched.append(key)
        filled.add(name)

    missing = [k for k in state_dict if k not in filled]
    report = {"matched": matched, "missing": missing,
              "unexpected": unexpected, "incorrect_shapes": incorrect}
    for k, cs, ms in incorrect:
        logger.warning(f"d2 import: shape mismatch for {k}: checkpoint "
                       f"{cs} vs model {ms}; keeping model init")
    if unexpected:
        logger.info(f"d2 import: {len(unexpected)} unexpected checkpoint keys "
                    f"(e.g. {unexpected[:3]})")
    if missing:
        logger.warning(f"d2 import: model params not in checkpoint: {missing}")
    logger.info(f"d2 import: matched {len(matched)} tensors")
    return new, report


def load_detectron2_weights(path: str, state, pooler_resolution: int = 7):
    """Load a reference-format checkpoint into a TrainState's models, in place.

    EnsembleTSModel checkpoints fill BOTH models from their own scopes; plain
    detector checkpoints fill the student (the reference's student-only load,
    ``detection_checkpoint.py:26-38``) and seed the teacher with the same weights,
    so ``--eval-only`` of either model and a warm-start mutual phase behave
    sensibly (the reference copies student -> teacher at the burn-in boundary
    anyway, ``trainer.py:292-298``).
    """
    student_sd, teacher_sd = split_ensemble(read_checkpoint_file(path))
    if student_sd:
        new, _ = d2_to_params(student_sd, state.student.state_dict(), pooler_resolution)
        state.student.load_state_dict(new)
    if teacher_sd:
        new, _ = d2_to_params(teacher_sd, state.teacher.state_dict(), pooler_resolution)
        state.teacher.load_state_dict(new)
    elif student_sd:
        state.teacher.load_state_dict(state.student.state_dict())
    return state


def is_d2_checkpoint(path: str) -> bool:
    """How the trainer routes MODEL.WEIGHTS: ``.pth``/``.pkl``/``.pt`` files go
    through this importer; the port's own ``model_*`` checkpoints do not."""
    return os.path.isfile(path) and path.endswith((".pth", ".pkl", ".pt"))
