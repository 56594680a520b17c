"""Box delta transform and probabilistic box densities (counterpart of the JAX
``ops/box_regression.py``).

xywh parameterization with per-coordinate weights, dw/dh clamped at
``log(1000/16)`` on decode, ``+1e-9`` inside the log ratio on encode; Gaussian and
Laplace densities with the sigma constant 0.3 in their normalizers.
"""

from __future__ import annotations

import math

import torch

SCALE_CLAMP = math.log(1000.0 / 16)
SIGMA_CONSTANT = 0.3


def get_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode target boxes as (dx, dy, dw, dh) deltas relative to src boxes.

    Shapes: (..., 4) x (..., 4) -> (..., 4). Zero-size src boxes divide by 1.
    """
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    safe_w = torch.where(src_w != 0, src_w, torch.ones_like(src_w))
    safe_h = torch.where(src_h != 0, src_h, torch.ones_like(src_h))
    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(tgt_w / safe_w + 1e-9)
    dh = wh * torch.log(tgt_h / safe_h + 1e-9)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Decode (..., K*4) deltas against (..., 4) boxes -> (..., K*4) XYXY boxes, in f32."""
    deltas = deltas.float()
    boxes = boxes.float()
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (shape[-1] // 4, 4))

    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(d[..., 3] / wh, max=SCALE_CLAMP)

    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(shape)


def gaussian_dist_pdf(val: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """Gaussian density with the sigma-constant-0.3 normalizer."""
    return torch.exp(-((val - mean) ** 2) / (var + eps) / 2.0) / torch.sqrt(
        2.0 * math.pi * (var + SIGMA_CONSTANT))


def laplace_dist_pdf(val: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-9) -> torch.Tensor:
    """Laplace density with the sigma-constant-0.3 normalizer."""
    return torch.exp(-torch.abs(val - mean) / torch.sqrt(var + eps)) / torch.sqrt(
        4.0 * (var + SIGMA_CONSTANT))


def nll(pdf_vals: torch.Tensor) -> torch.Tensor:
    """-log(pdf + 1e-9), elementwise."""
    return -torch.log(pdf_vals + 1e-9)
