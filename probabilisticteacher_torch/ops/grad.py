"""Gradient-flow utilities (counterpart of the JAX ``ops/grad.py``; reference
``pt/modeling/utils.py:31-60``).

- :func:`grad_zero`: identity forward, zero backward (the reference's ZeroLayer,
  which gates anchor gradients outside the danchor branch). In PyTorch this is
  ``detach``.
- :func:`grad_reverse`: the gradient reversal layer (GRLayer, ``alpha`` 0.1 in the
  reference): identity forward, backward multiplies the gradient by ``-alpha``.
  The reference's adversarial heads are dead code, but the utility is part of the
  JAX package's public surface.
"""

from __future__ import annotations

import torch


def grad_zero(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, zero gradient backward (ZeroLayer)."""
    return x.detach()


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Identity forward; backward multiplies the gradient by ``-alpha`` (GRLayer)."""
    return _GradReverse.apply(x, alpha)
