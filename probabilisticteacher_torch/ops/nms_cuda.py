"""Exact greedy NMS: the CUDA kernel ``csrc/nms.cu`` and its wrapper.

The sort by score, the areas and the fixed-buffer scatter stay in PyTorch, as
the JAX package keeps them outside its ``pallas_call``; the kernel takes the
sorted rows and returns the keep mask, one block per image, one launch per call.
It scans the rows in tiles of 64: the tile's own bits, a walk over them in
order by one thread, then the tile's kept rows suppress the later rows, with
three block barriers per tile instead of two per kept row.
A CPU tensor takes the plain :func:`ops.nms.greedy_keep`; a CUDA tensor launches
the kernel or raises. :func:`nms_keep` gives the kernel a null counter, and inside
:func:`ops.nms.recording_scans` it also keeps its rows; :func:`counting_keep` runs
the kernel's slower instantiation that adds the IoUs the scan needs into a device
counter (or ``greedy_keep``'s count on the CPU), and :func:`count_ious` counts
recorded scans that way, after the work they belonged to.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ._build import CudaKernel
from .nms import Scan, class_offset_boxes, greedy_keep, recorded_scans, select

KERNEL = CudaKernel(
    "nms.cu", "pt_nms_keep",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p],
    extra_flags=("-fmad=false",),
)


def nms_keep(boxes_s: torch.Tensor, area_s: torch.Tensor, valid_s: torch.Tensor,
             iou_thresh: float, max_keep: int) -> torch.Tensor:
    """Sorted rows (N, K, 4), (N, K), (N, K) -> keep mask (N, K) bool."""
    scans = recorded_scans()
    if scans is not None:
        scans.append(Scan(boxes_s, area_s, valid_s, float(iou_thresh), int(max_keep)))
    if boxes_s.device.type == "cpu":
        return greedy_keep(boxes_s, area_s, valid_s, iou_thresh, max_keep)
    return _launch(boxes_s, area_s, valid_s, iou_thresh, max_keep, None)


def counting_keep(boxes_s: torch.Tensor, area_s: torch.Tensor, valid_s: torch.Tensor,
                  iou_thresh: float, max_keep: int, count: torch.Tensor) -> torch.Tensor:
    """:func:`nms_keep`'s keep mask, the IoUs the scan needs added into ``count``, one
    int64 on the rows' device. On the card this is the kernel's counting
    instantiation: the same keep decisions, a few percent slower."""
    if count.device != boxes_s.device or count.dtype != torch.int64 or count.numel() != 1:
        raise ValueError(f"nms_keep: the IoU counter must be one int64 on {boxes_s.device}, "
                         f"got {count.dtype} {tuple(count.shape)} on {count.device}")
    if boxes_s.device.type == "cpu":
        return greedy_keep(boxes_s, area_s, valid_s, iou_thresh, max_keep, count)
    return _launch(boxes_s, area_s, valid_s, iou_thresh, max_keep, count)


def count_ious(scans: List[Scan]) -> int:
    """The IoUs that the recorded ``scans`` needed, counted now (one synchronize)."""
    if not scans:
        return 0
    count = torch.zeros(1, dtype=torch.int64, device=scans[0].boxes_s.device)
    for scan in scans:
        counting_keep(*scan, count)
    return int(count)


def _launch(boxes_s: torch.Tensor, area_s: torch.Tensor, valid_s: torch.Tensor,
            iou_thresh: float, max_keep: int, count: Optional[torch.Tensor]) -> torch.Tensor:
    if boxes_s.device.type != "cuda":
        raise ValueError(f"nms_keep: unsupported device {boxes_s.device}")
    n, k = valid_s.shape
    if boxes_s.shape != (n, k, 4) or area_s.shape != (n, k):
        raise ValueError(f"nms_keep: shapes {tuple(boxes_s.shape)}, {tuple(area_s.shape)}, "
                         f"{tuple(valid_s.shape)} do not match")
    for name, x, dt in (("boxes", boxes_s, torch.float32), ("area", area_s, torch.float32),
                        ("valid", valid_s, torch.bool)):
        if x.dtype != dt or not x.is_contiguous() or x.device != boxes_s.device:
            raise ValueError(f"nms_keep: {name} must be a contiguous {dt} tensor on "
                             f"{boxes_s.device}")
    keep = torch.empty((n, k), dtype=torch.uint8, device=boxes_s.device)
    if n == 0 or k == 0 or max_keep <= 0:
        return keep.zero_().bool()
    KERNEL.launch(boxes_s.data_ptr(), area_s.data_ptr(), valid_s.data_ptr(), keep.data_ptr(),
                  n, k, float(iou_thresh), int(max_keep),
                  torch.cuda.current_stream(boxes_s.device).cuda_stream,
                  None if count is None else count.data_ptr())
    return keep.bool()


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
        max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (K, 4) or (N, K, 4) boxes -> (indices, valid), (…, max_keep)."""
    return select(nms_keep, boxes, scores, valid, iou_thresh, max_keep)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                valid: torch.Tensor, iou_thresh: float,
                max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS via the coordinate-offset trick."""
    return nms(class_offset_boxes(boxes, idxs, valid), scores, valid, iou_thresh, max_keep)
