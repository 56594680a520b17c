"""Exact greedy NMS, plain PyTorch, with the JAX package's fixed-buffer output.

Counterpart of the JAX ``ops/nms.py::nms``/``batched_nms`` (the blocked solver)
and ``ops/nms_pallas.py`` (the scan kernel): all three give the same keep sets.
This module holds the parts around the keep decision, which the CUDA kernel in
``ops/nms_cuda.py`` shares, and :func:`greedy_keep`, the plain version of that
kernel, which the CPU runs and the card runs only to check the kernel.

- rows are ordered by ``where(valid, score, -inf)``, descending and stable (the
  lower index first among ties, as ``jnp.argsort(-s, stable=True)``);
- a row is kept when no earlier kept row has ``iou > t`` with it; invalid rows
  never keep and never suppress; at most ``max_keep`` rows are kept;
- the result is ``(max_keep,)`` indices into the original arrays in descending
  score order, plus a valid mask; invalid slots point at index 0.

Every function takes one image, ``(K, 4)``, or a batch, ``(N, K, 4)``.

The IoUs a greedy scan needs (:func:`greedy_keep`'s ``count``, and the kernel's
counting instantiation) are each valid row up to the row where the scan ends (the
``max_keep``-th kept row, or the last row) against every kept row ahead of it, up
to and including the first that suppresses it. Rows after the scan's end need
none. The IoUs a kernel evaluates beyond these are not counted. Counting slows the
kernel, so inside :func:`recording_scans` the keep decisions of this thread
(``ops/nms_cuda.py``'s ``nms_keep``) only keep their sorted rows, to be counted
later, away from the work being timed (``nms_cuda.count_ious``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch

from .boxes import area

KeepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float, int], torch.Tensor]



class Scan(NamedTuple):
    """The arguments of one keep decision: sorted rows, threshold, budget."""
    boxes_s: torch.Tensor
    area_s: torch.Tensor
    valid_s: torch.Tensor
    iou_thresh: float
    max_keep: int


_SCANS: contextvars.ContextVar[Optional[List[Scan]]] = contextvars.ContextVar(
    "scans", default=None)


@contextlib.contextmanager
def recording_scans(scans: List[Scan]) -> Iterator[None]:
    """Append each keep decision that this thread makes until the block ends to
    ``scans``; the rows stay on their device, unchanged, until ``scans`` is dropped."""
    token = _SCANS.set(scans)
    try:
        yield
    finally:
        _SCANS.reset(token)


def recorded_scans() -> Optional[List[Scan]]:
    """The list of the enclosing :func:`recording_scans`, or None."""
    return _SCANS.get()


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """(N, K, 4), (N, K), (N, K) -> order (N, K), boxes, areas and valid in that order."""
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    valid_s = torch.gather(valid, 1, order).contiguous()
    return order, boxes_s, area(boxes_s).contiguous(), valid_s


def greedy_keep(boxes_s: torch.Tensor, area_s: torch.Tensor, valid_s: torch.Tensor,
                iou_thresh: float, max_keep: int,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The greedy scan over sorted rows -> keep mask (N, K) bool.

    One step per kept row, all images at once: each image takes its first row
    that is neither suppressed nor already taken, and suppresses the rows whose
    IoU with it exceeds the threshold (``pairwise_iou`` operation for operation).
    ``count``, when given, gains the IoUs the scan needs (module docstring): each
    row still open when a row is kept is tested against it.
    """
    n, k = valid_s.shape
    dev = valid_s.device
    rows = torch.arange(n, device=dev)
    t = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = boxes_s.unbind(-1)
    done = ~valid_s            # suppressed or already taken
    keep = torch.zeros_like(valid_s)
    cols = torch.arange(k, device=dev)
    tested = torch.zeros((n, k), dtype=torch.int64, device=dev) if count is not None else None
    for _ in range(min(max_keep, k)):
        open_rows = ~done
        j = open_rows.to(torch.int8).argmax(dim=1)   # first open row (0 when none)
        found = open_rows[rows, j]
        if not bool(found.any()):
            break
        if tested is not None:   # the open rows after j test their IoU with j
            tested += open_rows & (cols > j[:, None]) & found[:, None]
        bj = boxes_s[rows, j]
        iw = torch.minimum(bj[:, 2:3], x1) - torch.maximum(bj[:, 0:1], x0)
        ih = torch.minimum(bj[:, 3:4], y1) - torch.maximum(bj[:, 1:2], y0)
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        union = area_s[rows, j][:, None] + area_s - inter
        iou = torch.where(inter > 0, inter / torch.where(union > 0, union, one), zero)
        done |= (iou > t) & found[:, None]
        done[rows, j] = True
        keep[rows, j] |= found
    if tested is not None:   # rows with max_keep kept rows ahead lie past the scan's end
        kept = keep.to(torch.int64)
        past_end = torch.cumsum(kept, dim=1) - kept >= max_keep
        count += torch.where(past_end, torch.zeros_like(tested), tested).sum()
    return keep


def fixed_buffer(keep: torch.Tensor, order: torch.Tensor,
                 max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept rows in score order -> (N, max_keep) int32 original indices and valid mask."""
    n = keep.shape[0]
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    ok = keep & (pos < max_keep)
    slot = torch.where(ok, pos, torch.full_like(pos, max_keep)).to(torch.int64)
    idx = torch.zeros((n, max_keep + 1), dtype=torch.int32, device=keep.device)
    idx.scatter_(1, slot, order.to(torch.int32))
    valid = torch.zeros((n, max_keep + 1), dtype=torch.bool, device=keep.device)
    valid.scatter_(1, slot, True)
    # column max_keep collects every row that was not kept; it is dropped
    return idx[:, :max_keep], valid[:, :max_keep]


def select(keep_fn: KeepFn, boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_thresh: float, max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort, decide the keep set with ``keep_fn``, and fill the fixed buffer."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    order, boxes_s, area_s, valid_s = sort_by_score(boxes, scores, valid.bool())
    keep = keep_fn(boxes_s, area_s, valid_s, iou_thresh, max_keep)
    idx, ok = fixed_buffer(keep, order, max_keep)
    return (idx[0], ok[0]) if single else (idx, ok)


def class_offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Shift each category's boxes apart so categories never overlap.

    ``max_coord = max(where(valid, boxes, 0)) + 1`` per image, offset
    ``idx * max_coord`` (torchvision ``batched_nms``'s coordinate trick).
    """
    valid = valid.bool()
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., 0]
    return boxes + offsets[..., None]


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
        max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS -> (indices (…, max_keep) int32, valid (…, max_keep) bool)."""
    return select(greedy_keep, boxes, scores, valid, iou_thresh, max_keep)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                valid: torch.Tensor, iou_thresh: float,
                max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS: boxes of different ``idxs`` never suppress each other."""
    return nms(class_offset_boxes(boxes, idxs, valid), scores, valid, iou_thresh, max_keep)
