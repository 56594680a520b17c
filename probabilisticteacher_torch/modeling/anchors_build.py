"""Anchor construction from an :class:`Arch` (counterpart of the JAX
``modeling/anchors_build.py``): the default grid, or the learnable (A, 2) table."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.anchors import cell_anchors_from_wh, default_cell_anchors, grid_anchors


def num_cell_anchors(arch) -> int:
    if arch.learnable_anchors:
        return len(arch.anchor_init_wh)
    return len(arch.anchor_sizes) * len(arch.anchor_aspects)


def init_anchor_params(arch) -> Optional[np.ndarray]:
    """Learnable (A, 2) wh table init, or None for the default generator."""
    if not arch.learnable_anchors:
        return None
    return np.asarray(arch.anchor_init_wh, dtype=np.float32)


def anchor_boxes(anchor_wh: Optional[torch.Tensor], arch, feat_h: int, feat_w: int,
                 device=None) -> torch.Tensor:
    """All anchors for one feature map -> (feat_h * feat_w * A, 4) XYXY."""
    if arch.learnable_anchors:
        cell = cell_anchors_from_wh(anchor_wh)
    else:
        cell = torch.as_tensor(
            default_cell_anchors(arch.anchor_sizes, arch.anchor_aspects), device=device)
    return grid_anchors(cell, feat_h, feat_w, arch.stride, arch.anchor_offset)
