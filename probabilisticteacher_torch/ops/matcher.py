"""Anchor/proposal matcher with static shapes (counterpart of the JAX
``ops/matcher.py``; detectron2 ``Matcher`` semantics).

Two matchers are used: the RPN's (thresholds (0.3, 0.7), labels (0, -1, 1), with
low-quality matches) and the ROI head's (threshold 0.5, labels (0, 1), without).
Padded ground-truth rows get IoU -1 (:func:`masked_iou`), so they never win the
argmax nor make a low-quality match; with no valid row every label is the first
interval's and every matched index is 0. Every function takes any leading batch
dims.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class MatchResult(NamedTuple):
    matched_idx: torch.Tensor  # (..., N) int64 row of the best ground truth
    labels: torch.Tensor       # (..., N) int8 from the matcher's label set


def masked_iou(iou: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """iou (..., M, N), gt_valid (..., M) -> iou with padded rows set to -1."""
    return torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))


def match(iou: torch.Tensor, thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality_matches: bool = False) -> MatchResult:
    """Matcher over an (..., M_gt, N_pred) quality matrix, already gt-masked.

    ``labels`` has one more entry than the ascending ``thresholds`` and labels the
    intervals (-inf, t0), [t0, t1), ..., [t_last, inf). ``torch.argmax`` returns the
    first maximum, as ``jnp.argmax`` does. Low-quality matches: every prediction
    that ties a real ground truth's best IoU gets label 1; its matched index is
    not changed.
    """
    matched_vals, _ = iou.max(dim=-2)
    matched_idx = iou.argmax(dim=-2)
    out = torch.full(matched_vals.shape, labels[0], dtype=torch.int8, device=iou.device)
    for lo, label in zip(thresholds, labels[1:]):
        out = torch.where(matched_vals >= lo, torch.full_like(out, label), out)
    if allow_low_quality_matches:
        highest = iou.max(dim=-1, keepdim=True).values            # (..., M, 1)
        is_best = (iou == highest) & (highest >= 0)
        out = torch.where(is_best.any(dim=-2), torch.ones_like(out), out)
    return MatchResult(matched_idx, out)
