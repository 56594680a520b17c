"""Strong augmentation and scale jitter on the card: the CUDA kernels ``csrc/device_aug.cu``
and their wrappers.

:func:`strong_augment` launches two kernels: ``GRAY_KERNEL`` sums, for each image
whose jitter gate is open, the gray levels that its contrast op averages, into
``PARTS`` partials an image; ``COLOR_KERNEL`` applies the jitter ops in each image's
order, grayscale, blur and solarize, tile by tile, skipping what each image's gates
close. :func:`scale_jitter` launches ``JITTER_KERNEL`` once. The draws stay on the
device: the kernels read each image's gates, factors, order, sigma and ratio there,
and nothing here waits on the card. ``data/device_aug.py`` calls these for any tensor
not on the CPU and keeps the plain PyTorch version for the CPU; the kernels match it
op for op (the source's note says where they may round the other way).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ._build import CudaKernel

PARTS = 128                    # gray-sum partials per image
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLAGS = ("-fmad=false",)      # PyTorch rounds each multiply and add apart

GRAY_KERNEL = CudaKernel(
    "device_aug.cu", "pt_aug_gray_sums",
    [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _F, _F, _F, _F, _P], extra_flags=_FLAGS)
COLOR_KERNEL = CudaKernel(
    "device_aug.cu", "pt_aug_color",
    [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I] + [_F] * 8 + [_P], extra_flags=_FLAGS)
JITTER_KERNEL = CudaKernel(
    "device_aug.cu", "pt_aug_scale_jitter",
    [_P, _I, _P, _I, _I, _I, _P, _P, _F, _F, _F, _P], extra_flags=_FLAGS)
KERNELS = (GRAY_KERNEL, COLOR_KERNEL, JITTER_KERNEL)
# the launches of one call: strong_augment, scale_jitter
STRONG_LAUNCHES, JITTER_LAUNCHES = 2, 1


def _bf16(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"device_aug: compute dtype must be float32 or bfloat16, got {dtype}")
    return int(dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _luma(weights: Tuple[float, ...], dtype: torch.dtype) -> Tuple[float, ...]:
    """The luma weights rounded to ``dtype``, as f32 numbers (a CPU tensor, no copy
    to the card)."""
    return tuple(torch.tensor(weights, dtype=dtype).float().tolist())


def _images(images: torch.Tensor, dtype: torch.dtype, keep_u8: bool) -> torch.Tensor:
    if images.device.type != "cuda":
        raise ValueError(f"device_aug: unsupported device {images.device}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"device_aug: images must be (N, H, W, 3), got {tuple(images.shape)}")
    if not (keep_u8 and images.dtype == torch.uint8):
        images = images.to(dtype)
    return images.contiguous()


def _param(x: torch.Tensor, dtype: torch.dtype, shape, like: torch.Tensor,
           name: str) -> torch.Tensor:
    if x.device != like.device or tuple(x.shape) != tuple(shape):
        raise ValueError(f"device_aug: {name} must be {tuple(shape)} on {like.device}, "
                         f"got {tuple(x.shape)} on {x.device}")
    return x.to(dtype).contiguous()


def strong_augment(images: torch.Tensor, draws, dtype: torch.dtype, gate_p: Sequence[float],
                   luma: Sequence[float]) -> torch.Tensor:
    """The strong stack on (N, H, W, 3) images (uint8 or any float) in ``dtype``,
    with ``draws`` an ``AugDraws`` on the images' card, ``gate_p`` the four gates'
    probabilities and ``luma`` the gray-level weights."""
    bf16 = _bf16(dtype)
    images = _images(images, dtype, keep_u8=True)
    n, h, w, _ = images.shape
    gates = _param(draws.gates, torch.float32, (n, 4), images, "gates")
    factors = _param(draws.factors, torch.float32, (n, 4), images, "factors")
    order = _param(draws.order, torch.int64, (n, 4), images, "order")
    sigma = _param(draws.sigma, torch.float32, (n,), images, "sigma")
    out = torch.empty((n, h, w, 3), dtype=dtype, device=images.device)
    if out.numel() == 0:
        return out
    parts = torch.empty((n, PARTS), dtype=torch.float32, device=images.device)
    lw = _luma(tuple(luma), dtype)
    u8 = int(images.dtype == torch.uint8)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    GRAY_KERNEL.launch(images.data_ptr(), u8, bf16, parts.data_ptr(), n, h, w, PARTS,
                       gates.data_ptr(), factors.data_ptr(), order.data_ptr(), *lw,
                       float(gate_p[0]), stream)
    # PyTorch's mean: the f32 sum times f32(N) / f32(N H W)
    mean_factor = float(np.float32(n) / np.float32(n * h * w))
    COLOR_KERNEL.launch(images.data_ptr(), u8, bf16, out.data_ptr(), n, h, w, gates.data_ptr(),
                        factors.data_ptr(), order.data_ptr(), sigma.data_ptr(), parts.data_ptr(),
                        PARTS, mean_factor, *lw, *(float(p) for p in gate_p), stream)
    return out


def scale_jitter(images: torch.Tensor, image_hw: torch.Tensor, ratio: torch.Tensor,
                 pixel_mean: Sequence[float], dtype: torch.dtype) -> torch.Tensor:
    """The jittered images (N, H, W, 3) in ``dtype``: each image shrunk by its
    ``ratio`` (N,) into the center of its valid ``image_hw`` (N, 2), ``pixel_mean``
    around it. The boxes' shift is the caller's."""
    bf16 = _bf16(dtype)
    images = _images(images, dtype, keep_u8=False)
    n, h, w, _ = images.shape
    hw = _param(image_hw, torch.float32, (n, 2), images, "image_hw")
    ratio = _param(ratio, torch.float32, (n,), images, "ratio")
    out = torch.empty_like(images)
    if out.numel() == 0:
        return out
    m0, m1, m2 = (float(m) for m in pixel_mean)
    JITTER_KERNEL.launch(images.data_ptr(), bf16, out.data_ptr(), n, h, w, hw.data_ptr(),
                         ratio.data_ptr(), m0, m1, m2,
                         torch.cuda.current_stream(images.device).cuda_stream)
    return out
