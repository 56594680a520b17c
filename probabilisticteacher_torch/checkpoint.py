"""Checkpointing: teacher + student + optimizer + step in one file, resume, Caffe VGG import.

Parity targets (the JAX package's ``checkpoint.py``, which stores the same state
with Orbax):
- ``DetectionTSCheckpointer`` over ``EnsembleTSModel``: one checkpoint holds
  modelTeacher + modelStudent + optimizer + iteration
  (``pt/checkpoint/detection_checkpoint.py:24-103``, ``pt/engine/trainer.py:104-111``);
- the ``model_{iter:07d}`` naming, the ``keep`` rotation and the ``last_checkpoint``
  marker that ``--resume`` follows (``trainer.py:466-496``);
- the student-only pretrained import (Caffe VGG16, ``vgg.py:127-152``):
  :func:`load_vgg_caffe`.

A checkpoint is one ``torch.save`` of ``{"step", "student", "teacher",
"optimizer"}``: the two ``state_dict`` s and :class:`ClippedSGD`'s state (momentum
and update count), written to a temporary name and renamed, so a reader never sees
half a file.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .modeling.backbone import VGG_STAGES
from .parallel.mesh import process_index

logger = logging.getLogger("probabilisticteacher_torch")

_PERIODIC = re.compile(r"model_\d{7}")


def _ckpt_path(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"model_{step:07d}")


def save_checkpoint(output_dir: str, state, keep: int = 100, name: str = "") -> str:
    """Save the TrainState at its current step; update the last_checkpoint marker.

    ``keep`` bounds retention: after a successful save, older ``model_*`` files
    beyond the newest ``keep`` are deleted. ``name`` saves to a fixed file (e.g.
    ``model_best``) WITHOUT touching the marker or the retention scan, so resume
    still follows the latest periodic checkpoint.

    Over several ranks every rank may call this; the replicas are identical, so
    rank 0 alone writes the file and the marker, and the others return its path.
    """
    step = int(state.step)
    path = os.path.join(os.path.abspath(output_dir), name) if name \
        else _ckpt_path(output_dir, step)
    if process_index() != 0:
        return path
    os.makedirs(output_dir, exist_ok=True)
    payload = {"step": step,
               "student": state.student.state_dict(),
               "teacher": state.teacher.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if name:
        return path
    with open(os.path.join(output_dir, "last_checkpoint"), "w") as f:
        f.write(os.path.basename(path))
    if keep > 0:
        ckpts = sorted(d for d in os.listdir(output_dir)
                       if _PERIODIC.fullmatch(d) and os.path.isfile(os.path.join(output_dir, d)))
        for old in ckpts[:-keep]:
            os.remove(os.path.join(output_dir, old))
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    marker = os.path.join(output_dir, "last_checkpoint")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    path = os.path.join(output_dir, name)
    return path if os.path.exists(path) else None


def _read(path: str, device) -> dict:
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def load_checkpoint(path: str, state):
    """Restore a TrainState saved by :func:`save_checkpoint` in place (full
    resume: both models, the optimizer's momentum and update count, the step)."""
    payload = _read(path, state.student.device)
    state.student.load_state_dict(payload["student"])
    state.teacher.load_state_dict(payload["teacher"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def load_weights(path: str, state, student_only: bool = False):
    """Load model weights only (the resume=False path, ``trainer.py:483-486``):
    the optimizer and the step stay as they are."""
    payload = _read(path, state.student.device)
    _load_like(state.student, payload["student"])
    if not student_only and "teacher" in payload:
        _load_like(state.teacher, payload["teacher"])
    return state


def _load_like(model: torch.nn.Module, loaded: Mapping[str, torch.Tensor]) -> None:
    """Copy ``loaded`` into ``model``, cast to its dtypes; keep the model's tensor
    when shapes differ (the reference checkpointer's shape-mismatch skipping,
    ``detection_checkpoint.py:52-103`` via fvcore)."""
    own = model.state_dict()
    out = {}
    for k, ref in own.items():
        new = loaded[k]
        if tuple(new.shape) != tuple(ref.shape):
            logger.warning(f"Checkpoint shape mismatch for {k}: {tuple(new.shape)} vs "
                           f"{tuple(ref.shape)}; keeping model init")
            out[k] = ref
        else:
            out[k] = new.to(ref.dtype)
    model.load_state_dict(out)


# --------------------------------------------------------------------------- #
# Caffe / torchvision VGG pretrained import (reference ``vgg.py:127-152``)
# --------------------------------------------------------------------------- #
def _vgg_torch_layout(depth: int):
    """torchvision ``features.*`` index -> our conv name, for any VGG depth.

    torchvision's no-norm VGG features are [Conv, ReLU]*k + MaxPool per stage, so
    conv indices advance by 2 per conv and 1 per pool: the enumeration the
    reference's importer walks (``pt/modeling/backbone/vgg.py:127-152``).
    """
    layout, idx = [], 0
    for bi, channels in enumerate(VGG_STAGES[depth], start=1):
        for ci, _ in enumerate(channels, start=1):
            layout.append((idx, f"block{bi}_conv{ci}"))
            idx += 2  # Conv + ReLU
        idx += 1  # MaxPool
    return layout


def _infer_vgg_depth(state_dict: Mapping[str, torch.Tensor]) -> int:
    conv_names = {k.split(".")[1] for k in state_dict if k.startswith("backbone.block")}
    for depth in VGG_STAGES:
        if {name for _, name in _vgg_torch_layout(depth)} == conv_names:
            return depth
    raise ValueError(f"Backbone params match no known VGG depth: {sorted(conv_names)}")


def load_vgg_caffe(state_dict: Mapping[str, torch.Tensor], path: str) -> Dict[str, torch.Tensor]:
    """Load Caffe/torchvision VGG weights (.pth via torch, or .npz) into the
    ``backbone.*`` entries of a copy of ``state_dict``; works for VGG 11/13/16/19
    (depth inferred from the keys).

    The Caffe model expects BGR 0-255 input with mean subtraction, exactly our
    preprocessing (``Arch.pixel_mean``). Its conv kernels are OIHW, the port's
    layout, so they are copied as they are (the JAX package transposes to HWIO).
    Raises FileNotFoundError if the file is absent.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npz"):
        raw = {k: torch.from_numpy(np.asarray(v)) for k, v in np.load(path).items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        raw = sd.get("state_dict", sd)
    out = dict(state_dict)
    for idx, name in _vgg_torch_layout(_infer_vgg_depth(state_dict)):
        wk, bk = f"features.{idx}.weight", f"features.{idx}.bias"
        if wk not in raw:
            raise KeyError(f"{wk} missing from {path}")
        for src, dst in ((wk, f"backbone.{name}.weight"), (bk, f"backbone.{name}.bias")):
            ref = state_dict[dst]
            if tuple(raw[src].shape) != tuple(ref.shape):
                raise ValueError(f"{src}: shape {tuple(raw[src].shape)}, model {dst} "
                                 f"{tuple(ref.shape)}")
            out[dst] = raw[src].to(device=ref.device, dtype=torch.float32)
    return out
