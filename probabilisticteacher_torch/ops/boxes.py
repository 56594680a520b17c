"""Box geometry primitives on XYXY tensors (counterpart of the JAX ``ops/boxes.py``).

Each function repeats the JAX expression operation for operation in f32, so the
two packages agree bit for bit on the same inputs wherever the hardware rounds
the same way; the exact NMS depends on that for ``pairwise_iou``.
"""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; last dim 4 -> scalar per box."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., M, 4) and (..., N, 4) boxes -> (..., M, N).

    Degenerate boxes give IoU 0 (guarded division, ``inter > 0`` gate).
    """
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Clip XYXY boxes to [0, w] x [0, h].

    ``image_hw``: (..., 2) as (h, w), broadcastable against ``boxes[..., 0]``.
    """
    h = image_hw[..., 0]
    w = image_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold (detectron2 ``Boxes.nonempty``)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def inside_box(boxes: torch.Tensor, image_hw: torch.Tensor,
               boundary_thresh: float = 0.0) -> torch.Tensor:
    """Mask of boxes fully inside the image plus a margin (the legacy RPN boundary
    filter). ``image_hw`` (..., 2) as (h, w), broadcastable against ``boxes[..., 0]``."""
    h = image_hw[..., 0]
    w = image_hw[..., 1]
    return ((boxes[..., 0] >= -boundary_thresh) & (boxes[..., 1] >= -boundary_thresh)
            & (boxes[..., 2] < w + boundary_thresh) & (boxes[..., 3] < h + boundary_thresh))
