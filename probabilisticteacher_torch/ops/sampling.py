"""Random subsampling with static shapes (counterpart of the JAX ``ops/sampling.py``;
detectron2 ``subsample_labels`` semantics).

A uniformly random subset without replacement is the top-k of iid uniform keys
over the eligible entries. The uniforms are an argument: tests pass the numbers
JAX drew, a caller with none passes a ``torch.Generator``. The top-k is a stable
descending sort, so tied keys go to the lower index as in ``jax.lax.top_k``. Every
function takes any leading batch dims and returns masks, not index lists.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SampleDraws(NamedTuple):
    """The uniforms of one :func:`subsample_labels` call: (..., N) each."""

    pos: torch.Tensor
    neg: torch.Tensor


class RowDraws(NamedTuple):
    """One rank's share of a global batch's draws: the uniforms of ``total`` rows are
    drawn from ``generator``, as one process over the whole batch would draw them,
    and the rows ``rows`` are kept."""

    generator: torch.Generator
    rows: torch.Tensor
    total: int


def draw_uniforms(shape, generator: Optional[torch.Generator], device) -> SampleDraws:
    """Fresh uniforms for :func:`subsample_labels` over ``shape`` = (..., N)."""
    return SampleDraws(torch.rand(shape, generator=generator, device=device),
                       torch.rand(shape, generator=generator, device=device))


def draw_rows(draws: RowDraws, shape, device) -> SampleDraws:
    """The uniforms of ``draws.rows`` for ``shape`` = (len(rows), N)."""
    if len(draws.rows) != shape[0]:
        raise ValueError(f"{len(draws.rows)} rows of draws for {shape[0]} rows")
    u = draw_uniforms((draws.total, *shape[1:]), draws.generator, device)
    rows = draws.rows.to(device)
    return SampleDraws(u.pos[rows], u.neg[rows])


def top_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: descending, the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_idx(keys: torch.Tensor, k: int) -> torch.Tensor:
    return top_desc(keys, k)[1]


def _mask_from_top(keys: torch.Tensor, eligible: torch.Tensor, k: int,
                   budget: torch.Tensor) -> torch.Tensor:
    """Mark the first min(budget, k) of the top-k keys; (..., N) bool."""
    idx = _top_idx(keys, k)
    take = torch.arange(idx.shape[-1], device=keys.device) < budget[..., None]
    mask = torch.zeros_like(eligible)
    return mask.scatter(-1, idx, take)


def random_topk_mask(eligible: torch.Tensor, k: int,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select min(k, #eligible) entries of ``eligible`` (..., N) at random.

    ``u`` (..., N) are the uniform keys. Returns (mask (..., N) bool, count (...)).
    """
    kk = min(k, eligible.shape[-1])
    keys = torch.where(eligible, u, torch.full_like(u, float("-inf")))
    count = torch.clamp(eligible.sum(-1), max=kk)
    return _mask_from_top(keys, eligible, kk, count), count


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     bg_label: int, draws: SampleDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 ``subsample_labels`` with masks; labels (..., N) int.

    Positives are labels not in {-1, bg_label}, negatives are ``bg_label``.
    Samples min(#pos, num_samples * positive_fraction) positives, then
    min(#neg, num_samples - #pos sampled) negatives. The negatives draw a full
    ``num_samples`` top-k and keep its head, as the JAX package does, so the
    same uniforms choose the same rows. Returns (pos_mask, neg_mask).
    """
    positive = (labels != -1) & (labels != bg_label)
    negative = labels == bg_label
    pos_mask, pos_count = random_topk_mask(positive, int(num_samples * positive_fraction),
                                           draws.pos)
    kk = min(num_samples, labels.shape[-1])
    keys = torch.where(negative, draws.neg, torch.full_like(draws.neg, float("-inf")))
    budget = torch.minimum(num_samples - pos_count, negative.sum(-1))
    return pos_mask, _mask_from_top(keys, negative, kk, budget)
