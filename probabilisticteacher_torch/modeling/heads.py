"""RPN head, box head and the Gaussian Fast R-CNN predictor (counterpart of the
JAX ``modeling/heads.py``).

Compute types follow the JAX package under AMP: the RPN convolutions and the box
head's fully connected layers run in bf16 (bias added in bf16 after the product),
while ``FastRCNNPredictor``'s two layers, flax ``nn.Dense`` with no ``dtype``,
promote the bf16 box-head output to f32 and compute in f32. Every head returns
f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W^T`` in ``dtype``, then ``+ b`` in ``dtype`` (flax Dense's two steps)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness (A) + 1x1 anchor deltas (A * box_dim)."""

    def __init__(self, num_anchors: int, box_dim: int = 8, conv_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchors = num_anchors
        self.box_dim = box_dim
        self.dtype = dtype
        self.conv = nn.Conv2d(conv_dim, conv_dim, 3, padding=1)
        self.objectness = nn.Conv2d(conv_dim, num_anchors, 1)
        self.deltas = nn.Conv2d(conv_dim, num_anchors * box_dim, 1)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat (N, H, W, C) -> objectness (N, H*W*A), deltas (N, H*W*A, box_dim), f32.

        The flattening order is (H, W, A), the order of ``grid_anchors``: the NCHW
        conv outputs are permuted back to NHWC before the reshape.
        """
        n, h, w, _ = feat.shape
        dt = self.dtype
        x = feat.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(F.conv2d(x, self.conv.weight.to(dt), self.conv.bias.to(dt), padding=1))
        obj = F.conv2d(x, self.objectness.weight.to(dt), self.objectness.bias.to(dt))
        deltas = F.conv2d(x, self.deltas.weight.to(dt), self.deltas.bias.to(dt))
        obj = obj.permute(0, 2, 3, 1).reshape(n, h * w * self.num_anchors)
        deltas = deltas.permute(0, 2, 3, 1).reshape(n, h * w * self.num_anchors, self.box_dim)
        return obj.float(), deltas.float()


class BoxHead(nn.Module):
    """num_fc x FC-fc_dim head over pooled ROI features (FastRCNNConvFCHead, FC only).

    ``fc1`` takes the pooled (P, P, C) block flattened in HWC order, the column
    order of the JAX package's (P*P*C, F) kernel, so the pooled tensor is never
    permuted.
    """

    def __init__(self, in_features: int, fc_dim: int = 1024, num_fc: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_features if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., P, P, C) -> (..., fc_dim) in ``dtype``."""
        x = x.flatten(-3)
        for i in range(self.num_fc):
            x = F.relu(_linear(x, getattr(self, f"fc{i + 1}"), self.dtype))
        return x


class FastRCNNPredictor(nn.Module):
    """Gaussian Fast R-CNN outputs: scores (K+1) and box deltas (K * box_dim), in f32."""

    def __init__(self, in_features: int, num_classes: int, box_dim: int = 8):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, num_classes * box_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.float()
        return (_linear(x, self.cls_score, torch.float32),
                _linear(x, self.bbox_pred, torch.float32))
