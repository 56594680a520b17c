"""MaxpoolNMS: pooling-based approximate NMS over the anchor grid (opt-in;
counterpart of the JAX ``ops/maxpool_nms.py``).

RPN objectness lives on a regular (H, W, A) anchor grid, so "suppress overlapping
lower-scored boxes" is approximated by keeping only local score maxima: one
3 x 3 max pool per anchor channel, plus a cross-anchor max at the same location.
It is an approximation, selected by ``MODEL.RPN.NMS_IMPL`` ``maxpool`` (or
``maxpool_train``, training passes only) and off by default; the final detection
NMS stays exact. ``hybrid`` uses :func:`maxpool_keep` as a prefilter before the
exact NMS (``PTDetector.predict_proposals``).

The JAX package pools with ``reduce_window`` outside any Pallas kernel, so the
pooling here is ``F.max_pool2d``, whose implicit padding is -inf like
``reduce_window``'s. Every function takes leading batch dims.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .sampling import top_desc


def maxpool_keep(scores_grid: torch.Tensor, pool: int = 3,
                 cross_anchor: bool = True) -> torch.Tensor:
    """Keep mask for (..., H, W, A) scores: local maxima per anchor channel.

    A location survives if it equals the max of its ``pool`` x ``pool`` spatial
    neighbourhood (per channel; every tied maximum survives) and, when
    ``cross_anchor``, also the max across anchor channels at its own location.
    """
    *lead, h, w, a = scores_grid.shape
    grid = scores_grid.reshape(-1, h, w, a)
    pooled = F.max_pool2d(grid.permute(0, 3, 1, 2), pool, stride=1, padding=pool // 2)
    keep = grid >= pooled.permute(0, 2, 3, 1)
    if cross_anchor:
        keep &= grid >= grid.amax(dim=-1, keepdim=True)
    return keep.reshape(scores_grid.shape)


def maxpool_nms_select(scores: torch.Tensor, grid_hw: Tuple[int, int], num_anchors: int,
                       post_topk: int, pool: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (..., R) in (H, W, A) row-major order -> (idx (..., post_topk), valid).

    Non-maxima are masked to -inf; the top ``post_topk`` survivors come back sorted
    by score, the lower index first among ties (as ``jax.lax.top_k``).
    """
    h, w = grid_hw
    keep = maxpool_keep(scores.reshape(*scores.shape[:-1], h, w, num_anchors), pool)
    masked = torch.where(keep.reshape(scores.shape), scores,
                         torch.full_like(scores, float("-inf")))
    top, idx = top_desc(masked, post_topk)
    return idx, torch.isfinite(top)
