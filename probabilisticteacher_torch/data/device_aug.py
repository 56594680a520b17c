"""On-device augmentation (counterpart of the JAX ``data/device_aug.py``).

The strong photometric stack (ColorJitter(.4, .4, .4, .1) with p .8, grayscale
p .2, Gaussian blur sigma U[0.1, 2] p .5, solarize(128) p .2) and the random
scale jitter, vectorized over the batch: each image's gate and parameters are
tensors, so nothing waits on the host. :func:`strong_augment` and
:func:`scale_jitter` run a CPU tensor through the plain PyTorch version
(:func:`strong_augment_plain`, :func:`scale_jitter_plain`), where an op that is
gated off for an image is computed and then dropped by ``torch.where``, and any
other through the CUDA kernels of ``ops/device_aug_cuda.py``, which compute only
the ops each image's gates open and match the plain version op for op.

Every random number is an argument (:class:`AugDraws` and the jitter ratios):
tests pass the numbers JAX drew, a caller with none draws them with
:func:`draw_aug` / :func:`draw_jitter` from a ``torch.Generator``.

Images are NHWC floats in 0..255, in the pixel compute dtype (bf16 under AMP).
The dtype rules are the JAX package's: the hue round trip runs in f32, the
contrast mean is taken in f32, and the jitter coordinates stay f32. As in the
reference, channel 0 is treated as "R" whatever the channel order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import device_aug_cuda

_LUMA = (0.299, 0.587, 0.114)
JITTER = (0.4, 0.4, 0.4, 0.1)        # brightness, contrast, saturation, hue
GATES = (0.8, 0.2, 0.5, 0.2)         # color jitter, grayscale, blur, solarize
BLUR_SIGMA = (0.1, 2.0)
BLUR_TAPS = 13


class AugDraws(NamedTuple):
    """The random numbers of :func:`strong_augment` for N images."""

    gates: torch.Tensor    # (N, 4) uniforms gating jitter, grayscale, blur, solarize
    factors: torch.Tensor  # (N, 4) brightness, contrast, saturation factors; hue delta
    order: torch.Tensor    # (N, 4) int64: a permutation of the four jitter ops
    sigma: torch.Tensor    # (N,) blur sigma


def draw_aug(n: int, generator: Optional[torch.Generator], device) -> AugDraws:
    """Fresh :class:`AugDraws` for n images."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    b, c, s, h = JITTER
    # lo + (hi - lo) * u in f32, a column at a time with the bounds as scalars: a
    # tensor of bounds would be a copy from the host, which waits on the card
    lo = np.float32([1 - b, 1 - c, 1 - s, -h])
    span = np.float32([1 + b, 1 + c, 1 + s, h]) - lo
    gates = u(n, 4)
    raw = u(n, 4)
    factors = torch.stack([raw[:, j] * float(span[j]) + float(lo[j]) for j in range(4)], dim=-1)
    order = torch.argsort(u(n, 4), dim=-1)
    sigma = BLUR_SIGMA[0] + (BLUR_SIGMA[1] - BLUR_SIGMA[0]) * u(n)
    return AugDraws(gates, factors, order, sigma)


def draw_jitter(n: int, generator: Optional[torch.Generator], device, lo: float = 0.5,
                hi: float = 1.0) -> torch.Tensor:
    """Fresh scale-jitter ratios U[lo, hi) for n images."""
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, 1, 1)


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """ratio * img1 + (1 - ratio) * img2 in the image dtype, clamped to [0, 255];
    ``ratio`` (N,) f32."""
    r = _per_image(ratio.float())
    return torch.clamp(r.to(img1.dtype) * img1 + (1.0 - r).to(img1.dtype) * img2, 0.0, 255.0)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """Luma in the image dtype (weights rounded to it, summed in f32, rounded once),
    broadcast to 3 channels."""
    luma = torch.tensor(_LUMA, dtype=img.dtype, device=img.device).float()
    l = (img.float() @ luma).to(img.dtype)
    return l[..., None].expand(img.shape)


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with each image's mean gray level, taken in f32."""
    mean = _grayscale(img)[..., 0].float().mean(dim=(1, 2)).to(img.dtype)
    return _blend(img, _per_image(mean).expand(img.shape), factor)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(img, _grayscale(img), factor)


def _rgb_to_hsv(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    one = torch.ones_like(maxc)
    zero = torch.zeros_like(maxc)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / torch.where(maxc > 0, maxc, one), zero)
    dc = torch.where(deltac > 0, deltac, one)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, maxc


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.to(torch.int64), 6)[None]
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # candidates stacked on a leading dim: contiguous copies, where a trailing-dim
    # stack would interleave them element by element
    r = torch.gather(torch.stack([v, q, p, p, t, v]), 0, i)[0]
    g = torch.gather(torch.stack([t, v, v, q, p, p]), 0, i)[0]
    b = torch.gather(torch.stack([p, p, t, v, v, q]), 0, i)[0]
    return torch.stack([r, g, b], dim=-1)


def adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Shift the hue by ``delta`` (N,): an HSV round trip in f32, cast back."""
    h, s, v = _rgb_to_hsv(img.float() / 255.0)
    h = torch.remainder(h + delta.float().reshape(-1, 1, 1), 1.0)
    return torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0.0, 255.0).to(img.dtype)


_JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(img: torch.Tensor, factors: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The four jitter ops in each image's own ``order`` with its own ``factors``."""
    for t in range(4):
        for o, op in enumerate(_JITTER_OPS):
            sel = _per_image(order[:, t] == o)
            img = torch.where(sel, op(img, factors[:, o]), img)
    return img


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, taps: int = BLUR_TAPS) -> torch.Tensor:
    """Separable Gaussian blur, one sigma per image, zero padding, in the image dtype.
    The kernel is built in f32, normalized, then rounded to the image dtype."""
    n, h, w, c = img.shape
    r = taps // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x ** 2) / (2.0 * sigma.float()[:, None] ** 2))
    k = (k / k.sum(-1, keepdim=True)).to(img.dtype)                       # (N, taps)
    k = k.repeat_interleave(c, dim=0)                                     # (N*C, taps)
    x4 = img.permute(0, 3, 1, 2).reshape(1, n * c, h, w)
    out = F.conv2d(x4, k[:, None, None, :], padding=(0, r), groups=n * c)
    out = F.conv2d(out, k[:, None, :, None], padding=(r, 0), groups=n * c)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def solarize(img: torch.Tensor, threshold: float = 128.0) -> torch.Tensor:
    """Invert pixels >= threshold."""
    return torch.where(img >= threshold, 255.0 - img, img)


def strong_augment(images: torch.Tensor, draws: AugDraws,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The strong stack on a batch (N, H, W, 3) in 0..255, computed in ``dtype``: the
    plain version on the CPU, the CUDA kernels elsewhere."""
    if images.device.type == "cpu":
        return strong_augment_plain(images, draws, dtype)
    return device_aug_cuda.strong_augment(images, draws, dtype, GATES, _LUMA)


def strong_augment_plain(images: torch.Tensor, draws: AugDraws,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`strong_augment` in plain PyTorch, on any device."""
    img = images.to(dtype)
    g = draws.gates
    img = torch.where(_per_image(g[:, 0] < GATES[0]),
                      color_jitter(img, draws.factors, draws.order), img)
    img = torch.where(_per_image(g[:, 1] < GATES[1]), _grayscale(img), img)
    img = torch.where(_per_image(g[:, 2] < GATES[2]), gaussian_blur(img, draws.sigma), img)
    img = torch.where(_per_image(g[:, 3] < GATES[3]), solarize(img), img)
    return img.contiguous()


def scale_jitter(images: torch.Tensor, image_hw: torch.Tensor, boxes: torch.Tensor,
                 pixel_mean: Sequence[float], ratio: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shrink each image by its ``ratio`` (N,) into the center of its valid (h, w),
    bilinear with half-pixel centers, and fill the rest with ``pixel_mean``; move
    ``boxes`` (N, ..., 4) the same way (``box * ratio + (x1, y1, x1, y1)``). The
    plain version on the CPU; elsewhere the CUDA kernel, the boxes as here.
    """
    if images.device.type == "cpu":
        return scale_jitter_plain(images, image_hw, boxes, pixel_mean, ratio, dtype)
    out = device_aug_cuda.scale_jitter(images, image_hw, ratio, pixel_mean, dtype)
    _, _, y1, x1 = _jitter_frame(image_hw.float(), ratio.float())
    return out, _move_boxes(boxes, ratio.float(), x1, y1)


def _jitter_frame(hw: torch.Tensor, ratio: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each image's shrunk size (d_h, d_w) and top-left corner (y1, x1), f32 (N,)."""
    d_h = torch.floor(hw[:, 0] * ratio)
    d_w = torch.floor(hw[:, 1] * ratio)
    y1 = torch.floor((hw[:, 0] - d_h) / 2.0)
    x1 = torch.floor((hw[:, 1] - d_w) / 2.0)
    return d_h, d_w, y1, x1


def _move_boxes(boxes: torch.Tensor, ratio: torch.Tensor, x1: torch.Tensor,
                y1: torch.Tensor) -> torch.Tensor:
    shape = (boxes.shape[0],) + (1,) * (boxes.dim() - 2)
    offs = torch.stack([x1, y1, x1, y1], dim=-1).reshape(shape + (4,))
    return boxes * ratio.reshape(shape + (1,)) + offs


def scale_jitter_plain(images: torch.Tensor, image_hw: torch.Tensor, boxes: torch.Tensor,
                       pixel_mean: Sequence[float], ratio: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scale_jitter` in plain PyTorch, on any device. The sampling coordinates
    stay f32; the blend weights are in ``dtype``."""
    img = images.to(dtype)
    n, h, w, _ = img.shape
    dev = img.device
    hw = image_hw.float()
    ratio = ratio.float()
    d_h, d_w, y1, x1 = _jitter_frame(hw, ratio)
    ar_h = torch.arange(h, dtype=torch.float32, device=dev)[None]
    ar_w = torch.arange(w, dtype=torch.float32, device=dev)[None]
    one = torch.ones((), device=dev)
    ys = (ar_h - y1[:, None] + 0.5) * (hw[:, 0] / torch.maximum(d_h, one))[:, None] - 0.5
    xs = (ar_w - x1[:, None] + 0.5) * (hw[:, 1] / torch.maximum(d_w, one))[:, None] - 0.5
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = torch.clamp(y0.long(), 0, h - 1)[:, :, None]
    y1i = torch.clamp(y0.long() + 1, 0, h - 1)[:, :, None]
    x0i = torch.clamp(x0.long(), 0, w - 1)[:, None, :]
    x1i = torch.clamp(x0.long() + 1, 0, w - 1)[:, None, :]
    bi = torch.arange(n, device=dev)[:, None, None]
    g00, g01 = img[bi, y0i, x0i], img[bi, y0i, x1i]
    g10, g11 = img[bi, y1i, x0i], img[bi, y1i, x1i]
    wy_ = wy.to(dtype)[:, :, None, None]
    wx_ = wx.to(dtype)[:, None, :, None]
    out = (g00 * (1 - wy_) * (1 - wx_) + g01 * (1 - wy_) * wx_
           + g10 * wy_ * (1 - wx_) + g11 * wy_ * wx_)
    in_y = (ar_h >= y1[:, None]) & (ar_h < (y1 + d_h)[:, None])
    in_x = (ar_w >= x1[:, None]) & (ar_w < (x1 + d_w)[:, None])
    inside = in_y[:, :, None, None] & in_x[:, None, :, None]
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev).to(dtype)
    out = torch.where(inside, out, mean)
    return out, _move_boxes(boxes, ratio, x1, y1)
