"""ROIAlign forward: the CUDA kernel ``csrc/roi_align_fwd.cu`` and its wrapper.

A CPU tensor takes the plain :func:`ops.roi_align.roi_align_batched`; a CUDA
tensor launches the kernel or raises. The kernel has no backward yet (the
training slice adds it), so a call that would need a gradient on the card raises
rather than return a tensor cut off from autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .roi_align import roi_align_batched

KERNEL = CudaKernel(
    "roi_align_fwd.cu", "pt_roi_align_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p],
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def roi_align(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features (N, H, W, C), boxes (N, R, 4) XYXY -> (N, R, p, p, C) in the feature dtype."""
    if features.device.type == "cpu":
        return roi_align_batched(features, boxes, spatial_scale, output_size, sampling_ratio)
    if features.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {features.device}")
    if torch.is_grad_enabled() and features.requires_grad:
        raise NotImplementedError(
            "roi_align: the ROIAlign backward kernel is not ported yet; call under "
            "torch.no_grad() on the card")
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != features.shape[0]:
        raise ValueError(f"roi_align: features {tuple(features.shape)} and boxes "
                         f"{tuple(boxes.shape)} are not (N, H, W, C) and (N, R, 4)")
    if features.dtype not in _DTYPES:
        raise ValueError(f"roi_align: features dtype {features.dtype} is not f32 or bf16")
    if boxes.device != features.device:
        raise ValueError("roi_align: features and boxes are on different devices")
    n, h, w, c = features.shape
    r = boxes.shape[1]
    p, s = output_size, max(sampling_ratio, 1)
    vec = 16 // features.element_size()
    if not features.is_contiguous() or c % vec or features.data_ptr() % 16:
        raise ValueError(f"roi_align: features must be contiguous NHWC, 16-byte aligned, with "
                         f"C a multiple of {vec}")
    if p * s > 64:
        raise ValueError(f"roi_align: output_size * sampling_ratio = {p * s} exceeds 64")
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((n, r, p, p, c), dtype=features.dtype, device=features.device)
    if n * r == 0:
        return out
    KERNEL.launch(features.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, h, w, c, r, p, s,
                  float(spatial_scale), _DTYPES[features.dtype],
                  torch.cuda.current_stream(features.device).cuda_stream)
    return out
