"""Replay the JAX package's random draws into the port's draw arguments.

The port never imports JAX; its random functions take the drawn numbers as
arguments instead. These helpers call the same ``jax.random`` splits as the JAX
package's ``ops/sampling.py``, ``data/device_aug.py``, ``modeling/detector.py``
and ``engine/steps.py``, and return the numbers as the port's ``SampleDraws``,
``LossDraws``, ``AugDraws`` and ``StepDraws``.
"""

import jax
import numpy as np
import torch

from probabilisticteacher_torch.data.device_aug import AugDraws
from probabilisticteacher_torch.engine.steps import StepDraws
from probabilisticteacher_torch.modeling.detector import LossDraws
from probabilisticteacher_torch.ops.sampling import SampleDraws


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def sample_draws(key, n: int, r: int) -> SampleDraws:
    """``subsample_labels`` under ``vmap`` over n images of r rows."""
    pos, neg = [], []
    for k in jax.random.split(key, n):
        kp, kn = jax.random.split(k)
        pos.append(jax.random.uniform(kp, (r,)))
        neg.append(jax.random.uniform(kn, (r,)))
    return SampleDraws(_t(np.stack(pos)), _t(np.stack(neg)))


def loss_draws(key, n: int, r_anchors: int, r_rois: int) -> LossDraws:
    """``supervised_losses(..., rng)``: RPN sampling from the first split, ROI from the second."""
    kr, ko = jax.random.split(key)
    return LossDraws(sample_draws(kr, n, r_anchors), sample_draws(ko, n, r_rois))


def student_draws(key, n_l: int, n_u: int, r_anchors: int, r_rois: int) -> LossDraws:
    """``student_losses(..., rng)``: the split branch passes one more split down."""
    if (n_l + n_u) % 8 != 0:
        key = jax.random.split(key)[0]
    return loss_draws(key, n_l, r_anchors, r_rois)


def aug_draws(key, n: int) -> AugDraws:
    """``strong_augment(key, images)`` for n images."""
    gates, factors, order, sigma = [], [], [], []
    for k in jax.random.split(key, n):
        k1, _, k3, _, p1, p2, p3, p4 = jax.random.split(k, 8)
        gates.append([float(jax.random.uniform(p)) for p in (p1, p2, p3, p4)])
        kb, kc, ks, kh, kp = jax.random.split(k1, 5)
        factors.append([float(jax.random.uniform(kb, (), minval=0.6, maxval=1.4)),
                        float(jax.random.uniform(kc, (), minval=0.6, maxval=1.4)),
                        float(jax.random.uniform(ks, (), minval=0.6, maxval=1.4)),
                        float(jax.random.uniform(kh, (), minval=-0.1, maxval=0.1))])
        order.append(np.asarray(jax.random.permutation(kp, 4)))
        sigma.append(float(jax.random.uniform(k3, (), minval=0.1, maxval=2.0)))
    return AugDraws(torch.tensor(gates, dtype=torch.float32),
                    torch.tensor(factors, dtype=torch.float32),
                    torch.from_numpy(np.stack(order).astype(np.int64)),
                    torch.tensor(sigma, dtype=torch.float32))


def jitter_draws(key, n: int, lo: float = 0.5, hi: float = 1.0) -> torch.Tensor:
    """``scale_jitter(key, images, ...)`` ratios for n images."""
    return torch.tensor([float(jax.random.uniform(k, (), minval=lo, maxval=hi))
                         for k in jax.random.split(key, n)], dtype=torch.float32)


def burnin_draws(rng, step: int, n: int, r_anchors: int, r_rois: int) -> StepDraws:
    k_aug, k_jit, k_sup = jax.random.split(jax.random.fold_in(rng, step), 3)
    return StepDraws(aug_draws(k_aug, n), jitter_draws(k_jit, 2 * n),
                     loss_draws(k_sup, 2 * n, r_anchors, r_rois))


def mutual_draws(rng, step: int, n_l: int, n_u: int, r_anchors: int, r_rois: int) -> StepDraws:
    k_aug_l, k_aug_u, k_jit_l, k_jit_u, k_sup = jax.random.split(
        jax.random.fold_in(rng, step), 5)
    return StepDraws(aug_draws(k_aug_l, n_l), jitter_draws(k_jit_l, n_l),
                     student_draws(k_sup, 2 * n_l, n_u, r_anchors, r_rois),
                     aug_draws(k_aug_u, n_u), jitter_draws(k_jit_u, n_u))
