"""Anchor generation (counterpart of the JAX ``ops/anchors.py``).

Covers the default generator (sizes x aspect ratios) and the learnable (A, 2)
table of (w, h) pairs of ``DifferentiableAnchorGenerator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def default_cell_anchors(sizes, aspect_ratios) -> np.ndarray:
    """(len(sizes)*len(aspect_ratios), 4) XYXY anchors centered at (0, 0).

    For area size^2 and aspect a (h/w): w = sqrt(area/a), h = a*w. Ordering: for
    each size, for each aspect ratio.
    """
    anchors = []
    for size in sizes:
        anchor_area = float(size) ** 2
        for a in aspect_ratios:
            w = math.sqrt(anchor_area / a)
            h = a * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def cell_anchors_from_wh(wh_table: torch.Tensor) -> torch.Tensor:
    """Learnable table (A, 2) of (w, h) -> (A, 4) XYXY cell anchors."""
    w = wh_table[:, 0]
    h = wh_table[:, 1]
    return torch.stack([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0], dim=-1)


def grid_anchors(cell_anchors: torch.Tensor, feat_h: int, feat_w: int, stride: int,
                 offset: float = 0.0) -> torch.Tensor:
    """Tile (A, 4) cell anchors over an (feat_h, feat_w) grid -> (H*W*A, 4).

    Row-major over (y, x), anchors fastest: the (H, W, A) order of the RPN head's
    flattened outputs.
    """
    dev = cell_anchors.device
    shifts_x = (torch.arange(feat_w, dtype=torch.float32, device=dev) + offset) * stride
    shifts_y = (torch.arange(feat_h, dtype=torch.float32, device=dev) + offset) * stride
    sx = shifts_x[None, :].expand(feat_h, feat_w).reshape(-1)
    sy = shifts_y[:, None].expand(feat_h, feat_w).reshape(-1)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)  # (H*W, 4)
    return (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4)
