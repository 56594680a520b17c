"""Static-shape data structures, the PyTorch counterparts of
``probabilisticteacher_tpu/structures.py``.

Every structure is a batch-level NamedTuple of fixed-size tensors plus a
``valid`` mask, with the same fields, shapes and dtypes as the JAX package, so
the two packages' outputs compare field by field.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import torch


class GroundTruth(NamedTuple):
    """Padded ground-truth annotations for a batch."""

    boxes: torch.Tensor    # (N, G, 4) XYXY in canvas coordinates, f32
    classes: torch.Tensor  # (N, G) int32 in [0, K)
    valid: torch.Tensor    # (N, G) bool


class PseudoLabels(NamedTuple):
    """Teacher detections used as soft pseudo-labels."""

    boxes: torch.Tensor   # (N, T, 4) XYXY, f32
    logits: torch.Tensor  # (N, T, K+1) raw teacher class logits (pre-softmax)
    sigma: torch.Tensor   # (N, T, 4) raw teacher box sigma logits (pre-sigmoid)
    valid: torch.Tensor   # (N, T) bool


class Proposals(NamedTuple):
    """RPN proposals after NMS."""

    boxes: torch.Tensor   # (N, P, 4) XYXY, f32
    logits: torch.Tensor  # (N, P) objectness scores (post sigma-rescale), f32
    valid: torch.Tensor   # (N, P) bool


class Detections(NamedTuple):
    """Final detector output."""

    boxes: torch.Tensor    # (N, D, 4) XYXY, f32
    scores: torch.Tensor   # (N, D) f32 (sigma-discounted)
    classes: torch.Tensor  # (N, D) int32 in [0, K)
    logits: torch.Tensor   # (N, D, K+1) raw class logits of the source proposal
    sigma: torch.Tensor    # (N, D, 4) raw sigma logits for the predicted class
    valid: torch.Tensor    # (N, D) bool


class ImageBatch(NamedTuple):
    """A padded image batch: raw pixels on a static canvas, zero beyond ``image_hw``."""

    image: torch.Tensor     # (N, H, W, 3) f32 (raw 0..255 pixel values)
    image_hw: torch.Tensor  # (N, 2) f32 valid (h, w)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    Raises when the card is asked for (explicitly or by default) and none is
    present; the port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "probabilisticteacher_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
    prints them, or "no nvidia-smi"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"
