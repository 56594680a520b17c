"""ROIAlign on the card: the CUDA kernels ``csrc/roi_align_fwd.cu`` (forward) and
``csrc/roi_align_bwd.cu`` (d features), their wrappers, and the
``torch.autograd.Function`` that joins them.

A CPU tensor takes the plain versions of ``ops/roi_align.py``
(:func:`roi_align_batched` forward, :func:`roi_align_bwd_plain` backward); a CUDA
tensor launches the kernel or raises. Boxes get no gradient: the JAX package stops
it everywhere, and every caller passes boxes that are already detached.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import CudaKernel
from .roi_align import batched_pool_matrices, roi_align_batched, roi_align_bwd_plain

KERNEL = CudaKernel(
    "roi_align_fwd.cu", "pt_roi_align_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                  ctypes.c_void_p],
)
BWD_KERNEL = CudaKernel(
    "roi_align_bwd.cu", "pt_roi_align_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the backward kernel's limits (csrc/roi_align_bwd.cu checks them too): the shared
# memory one block may opt in to on sm_90, its threads, and p
BWD_SMEM_BYTES = 232448
BWD_THREADS = 512
BWD_MAX_BINS = 32


class BwdPlan(NamedTuple):
    """How the backward kernel tiles dF: tiles of ``th`` x ``tw`` map cells with
    every channel, ``tiles_y`` x ``tiles_x`` of them per image; tables for ``batch``
    ROIs at a time; ``smem`` bytes of shared memory a block."""
    th: int
    tw: int
    tiles_y: int
    tiles_x: int
    batch: int
    smem: int


def bwd_smem(th: int, tw: int, c: int, p: int, batch: int) -> int:
    """Shared memory of one block, in the order ``csrc/roi_align_bwd.cu`` lays it
    out: the f32 accumulator (th, tw, C), the block's list of ROIs (512 int4), the
    tables of a batch of them (Wy, Wx, the tile rows of each bin q, the column masks,
    the bin masks) and the warps' counts. The launch passes the total; the kernel
    traps if its layout does not fit."""
    return 4 * (th * tw * c + 4 * BWD_THREADS + batch * (p * (th + tw + 2) + tw + 2)
                + BWD_THREADS // 32)


def bwd_plan(h: int, w: int, c: int, p: int) -> BwdPlan:
    """The tiling of ``csrc/roi_align_bwd.cu`` for an (H, W, C) map and p x p bins.

    A column of a tile goes to a group of C / 16 lanes (C / 4 where C is not a
    multiple of 16), so a block of 512 threads works on 512 / lanes columns at
    once. For each batch size and band height, the widest tile that fits the
    shared memory, evened out over the map. The plan taken minimises the tile
    visits of a ROI about p cells across, (th + p)(tw + p) / (th tw), over the
    share of the groups that have a column (tw over tw rounded up to a multiple
    of the groups); then the fewest tiles. Raises where p is over 32 or a column
    needs more than 512 lanes.
    """
    lanes = c // 16 if c % 16 == 0 else c // 4
    if lanes > BWD_THREADS or p > BWD_MAX_BINS:
        raise ValueError(f"roi_align_backward: {c} channels ({lanes} lanes a column) or "
                         f"output_size {p} beyond the kernel's {BWD_THREADS} lanes and "
                         f"{BWD_MAX_BINS} bins")
    groups = BWD_THREADS // lanes
    best = None
    for batch in (32, 16, 8):
        if 2 * p * batch > BWD_THREADS:
            continue
        for th in range(1, h + 1):
            free = (BWD_SMEM_BYTES // 4 - 4 * BWD_THREADS - batch * (p * (th + 2) + 2)
                    - BWD_THREADS // 32)
            tw = min(w, free // (th * c + batch * (p + 1)))
            if tw < 1:
                break
            ny, nx = -(-h // th), -(-w // tw)
            th_e, tw_e = -(-h // ny), -(-w // nx)
            used = tw_e / (-(-tw_e // groups) * groups)
            key = ((th_e + p) * (tw_e + p) / (th_e * tw_e) / used, ny * nx)
            if best is None or key < best[0]:
                best = (key, BwdPlan(th_e, tw_e, ny, nx, batch,
                                     bwd_smem(th_e, tw_e, c, p, batch)))
    return best[1]


def _check(shape, dtype: torch.dtype, device: torch.device, boxes: torch.Tensor, p: int,
           s: int, name: str) -> None:
    """Raise on what the kernels do not take: a map ``shape`` (N, H, W, C) of ``dtype``
    on ``device`` and boxes (N, R, 4) beside it."""
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if len(shape) != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.shape[0] != shape[0]:
        raise ValueError(f"{name}: features {tuple(shape)} and boxes {tuple(boxes.shape)} are "
                         "not (N, H, W, C) and (N, R, 4)")
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: features dtype {dtype} is not f32 or bf16")
    if boxes.device != device:
        raise ValueError(f"{name}: features and boxes are on different devices")
    if p * s > 64 or s > 4:
        raise ValueError(f"{name}: output_size {p} x sampling_ratio {s} is beyond the "
                         "kernels' limits (p * s <= 64, s <= 4)")


def _check_aligned(x: torch.Tensor, name: str, what: str) -> None:
    vec = 16 // x.element_size()
    if not x.is_contiguous() or x.shape[-1] % vec or x.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous, 16-byte aligned, with its last "
                         f"dim a multiple of {vec}")


def roi_align_forward(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                      output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features (N, H, W, C), boxes (N, R, 4) XYXY -> (N, R, p, p, C) in the feature dtype."""
    if features.device.type == "cpu":
        return roi_align_batched(features, boxes, spatial_scale, output_size, sampling_ratio)
    p, s = output_size, max(sampling_ratio, 1)
    _check(features.shape, features.dtype, features.device, boxes, p, s, "roi_align")
    _check_aligned(features, "roi_align", "features (N, H, W, C)")
    n, h, w, c = features.shape
    r = boxes.shape[1]
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((n, r, p, p, c), dtype=features.dtype, device=features.device)
    if n * r == 0:
        return out
    KERNEL.launch(features.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, h, w, c, r, p, s,
                  float(spatial_scale), _DTYPES[features.dtype],
                  torch.cuda.current_stream(features.device).cuda_stream)
    return out


def roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor, feat_shape, dtype: torch.dtype,
                       spatial_scale: float, output_size: int = 7,
                       sampling_ratio: int = 2) -> torch.Tensor:
    """d features: grad (N, R, p, p, C), boxes (N, R, 4) -> (N, H, W, C) in ``dtype``.

    ``grad`` is cast to the feature dtype first, as the JAX package does. On the
    card each block owns a tile of dF (:func:`bwd_plan`) and adds into it in a fixed
    order, so dF is the same bit for bit from run to run.
    """
    n, h, w, c = feat_shape
    p, s = output_size, max(sampling_ratio, 1)
    grad = grad.to(dtype)
    if grad.device.type == "cpu":
        wy, wx = batched_pool_matrices(boxes, h, w, spatial_scale, p, s, dtype)
        return roi_align_bwd_plain(wy, wx, grad)
    grad = grad.contiguous()
    _check(feat_shape, dtype, grad.device, boxes, p, s, "roi_align_backward")
    r = boxes.shape[1]
    if grad.shape != (n, r, p, p, c) or c % 4:
        raise ValueError(f"roi_align_backward: grad {tuple(grad.shape)} is not "
                         f"{(n, r, p, p, c)} with C a multiple of 4")
    _check_aligned(grad, "roi_align_backward", "grad (N, R, p, p, C)")
    plan = bwd_plan(h, w, c, p)
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((n, h, w, c), dtype=dtype, device=grad.device)
    if out.numel() == 0:
        return out
    BWD_KERNEL.launch(grad.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, h, w, c, r, p, s,
                      float(spatial_scale), _DTYPES[dtype], plan.th, plan.tw, plan.batch,
                      plan.smem, torch.cuda.current_stream(grad.device).cuda_stream)
    return out


class RoIAlignFunction(torch.autograd.Function):
    """ROIAlign with d features: forward K1 (or its plain version on the CPU),
    backward K2 (or :func:`roi_align_bwd_plain`). The boxes get no gradient."""

    @staticmethod
    def forward(ctx, features, boxes, spatial_scale, output_size, sampling_ratio):
        ctx.save_for_backward(boxes)
        ctx.meta = (tuple(features.shape), features.dtype, spatial_scale, output_size,
                    sampling_ratio)
        return roi_align_forward(features, boxes, spatial_scale, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        shape, dtype, scale, p, s = ctx.meta
        dfeat = None
        if ctx.needs_input_grad[0]:
            dfeat = roi_align_backward(grad, boxes, shape, dtype, scale, p, s)
        return dfeat, None, None, None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """Differentiable ROIAlign: features (N, H, W, C), boxes (N, R, 4) XYXY ->
    (N, R, p, p, C) in the feature dtype; the gradient reaches the features only."""
    return RoIAlignFunction.apply(features, boxes.detach(), spatial_scale, output_size,
                                  sampling_ratio)
