"""ROIAlign, plain PyTorch (aligned=True, fixed s x s sampling).

Counterpart of the JAX ``ops/roi_align.py::roi_align_mxu`` and
``roi_align_batched``, and the plain version of the CUDA kernel in
``ops/roi_align_cuda.py``: the CPU runs it, and the card runs it only to check
the kernel.

Bilinear sampling is a 2-tap linear map per axis and the s x s sample average is
linear too, so sampling and pooling fold into per-ROI matrices Wy (R, p, H) and
Wx (R, p, W):  ``out[r, y, x, c] = sum_h sum_w Wy[r, y, h] F[h, w, c] Wx[r, x, w]``.
The contraction runs in the feature dtype (bf16 under AMP) with the weights
rounded to it, as in the JAX package. Layout: features NHWC, boxes XYXY in image
coordinates, ``spatial_scale`` = 1/stride.
"""

from __future__ import annotations

from typing import Tuple

import torch

# ROIs per matmul pair: bounds the (chunk, p, W, C) intermediate whatever R is
ROI_CHUNK = 512


def _sample_points(boxes: torch.Tensor, p: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI bilinear sample coordinates: (R, p*s) for y and x (boxes already scaled).

    The divisors are tensors, not Python numbers: on CUDA, PyTorch divides by a
    Python number as a multiply by its rounded reciprocal, an ulp away from the
    true quotient that JAX and the kernel compute. An ulp can move a sample across
    the out-of-bounds edge, where the result jumps.
    """
    dev = boxes.device
    p_div = torch.tensor(float(p), device=dev)
    s_div = torch.tensor(float(s), device=dev)
    grid_p = torch.arange(p, dtype=torch.float32, device=dev)
    grid_s = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s_div
    off = (grid_p[:, None] + grid_s[None, :]).reshape(-1)  # (p*s,)
    x1, y1, x2, y2 = boxes.unbind(-1)
    ys = y1[:, None] + off[None] * ((y2 - y1) / p_div)[:, None]
    xs = x1[:, None] + off[None] * ((x2 - x1) / p_div)[:, None]
    return ys, xs


def _interp_matrix(points: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear interpolation weights as a dense matrix: (R, K, size).

    W[r, k, i] = weight of source row i for sample k: the 2-tap bilinear weights
    (clip to [0, size-1], zero outside [-1, size]).
    """
    oob = (points < -1.0) | (points > size)
    v = torch.clamp(points, 0.0, float(size - 1))
    i0 = torch.floor(v).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    lo = v - i0.to(v.dtype)
    hi = 1.0 - lo
    ar = torch.arange(size, device=points.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    w0 = torch.where(oob, zero, hi)[..., None] * (i0[..., None] == ar)
    w1 = torch.where(oob, zero, lo)[..., None] * (i1[..., None] == ar)
    return w0 + w1


def pool_matrices(boxes: torch.Tensor, h: int, w: int, spatial_scale: float,
                  p: int, s: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (R, 4) -> Wy (R, p, H), Wx (R, p, W), the s samples averaged, in ``dtype``."""
    r = boxes.shape[0]
    scaled = boxes.float() * spatial_scale - 0.5
    ys, xs = _sample_points(scaled, p, s)
    wy = _interp_matrix(ys, h).reshape(r, p, s, h).mean(2)
    wx = _interp_matrix(xs, w).reshape(r, p, s, w).mean(2)
    return wy.to(dtype), wx.to(dtype)


def roi_align_mxu(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                  output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign of one image as two interpolation matmuls.

    features (H, W, C), boxes (R, 4) -> (R, p, p, C) in the feature dtype.
    """
    h, w, c = features.shape
    r = boxes.shape[0]
    p, s = output_size, max(sampling_ratio, 1)
    wy, wx = pool_matrices(boxes, h, w, spatial_scale, p, s, features.dtype)
    # tmp[r, y, w, c] = sum_h wy[r, y, h] * F[h, w, c]
    tmp = (wy.reshape(r * p, h) @ features.reshape(h, w * c)).reshape(r, p, w, c)
    # out[r, y, x, c] = sum_w wx[r, x, w] * tmp[r, y, w, c]
    return torch.einsum("rxw,rywc->ryxc", wx, tmp)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                      output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features (N, H, W, C), boxes (N, R, 4) -> (N, R, p, p, C), in chunks of ROI_CHUNK."""
    n, r = boxes.shape[:2]
    p = output_size
    out = features.new_empty((n, r, p, p, features.shape[-1]))
    for i in range(n):
        for lo in range(0, r, ROI_CHUNK):
            hi = min(lo + ROI_CHUNK, r)
            out[i, lo:hi] = roi_align_mxu(features[i], boxes[i, lo:hi], spatial_scale,
                                          output_size, sampling_ratio)
    return out
