"""Loss primitives of Probabilistic Teacher (counterpart of the JAX ``ops/losses.py``).

Every function takes validity masks instead of boolean indexing, so shapes stay
static and masked entries contribute exactly zero. The guards of the JAX package
are kept as they are, because without them masked rows give NaN gradients in
PyTorch just as in JAX: the double ``where`` around ``p * log p`` in the EFL
weight, the ``+ 1e-9`` inside every log, and the empty-set normalizers clamped
to 1.

Each data-dependent normalizer is a count over the global batch: inside a data
parallel train step, ``parallel.mesh.global_sum`` sums it over the ranks before
the clamp, as the JAX package counts over the batch it shards (a world of one,
and anything outside a train step, counts its own rows).
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import global_sum
from .box_regression import gaussian_dist_pdf, laplace_dist_pdf


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x)).sum()


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(global_sum(mask.float().sum()), min=1.0)


def binary_cross_entropy_with_logits_sum(logits: torch.Tensor, targets: torch.Tensor,
                                         mask: torch.Tensor) -> torch.Tensor:
    """Masked sum of BCE-with-logits (RPN objectness), in the stable form
    ``max(x, 0) - x y + log(1 + exp(-|x|))``. ``torch.maximum`` splits the gradient
    of a tie as ``jnp.maximum`` does; ``clamp`` would not."""
    loss = torch.maximum(logits, torch.zeros_like(logits)) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return _masked_sum(loss, mask)


def softmax_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """Masked mean cross entropy over valid rows (ROI supervised classification)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_sum(nll, valid) / _count(valid)


def prob_box_nll_sum(pred_mean: torch.Tensor, pred_sigma_raw: torch.Tensor,
                     gt_deltas: torch.Tensor, mask: torch.Tensor,
                     model_type: str = "GUASSIAN") -> torch.Tensor:
    """Sum over masked rows of -log(pdf(gt_delta; mean, sigmoid(sigma_raw)) + 1e-9)."""
    var = torch.sigmoid(pred_sigma_raw)
    pdf_fn = laplace_dist_pdf if model_type == "LAPLACE" else gaussian_dist_pdf
    nll = -torch.log(pdf_fn(pred_mean, gt_deltas, var) + 1e-9)
    return _masked_sum(nll, mask[..., None].expand_as(nll))


def efl_class_weight(teacher_logits: torch.Tensor, lam: float) -> torch.Tensor:
    """Entropy focal weight from teacher class logits: (1 - H(softmax(t)) / log n) ** lam.

    ``p log p`` is 0 where p underflows to 0 (the double ``where`` keeps its
    gradient finite too)."""
    p = torch.softmax(teacher_logits, dim=-1)
    pos = p > 0
    plogp = torch.where(pos, p * torch.log(torch.where(pos, p, torch.ones_like(p))),
                        torch.zeros_like(p))
    entropy = -plogp.sum(-1)
    return (1.0 - entropy / math.log(teacher_logits.shape[-1])) ** lam


def efl_box_weight(sigma_p: torch.Tensor, lam: float,
                   model_type: str = "GUASSIAN") -> torch.Tensor:
    """Entropy focal weight from the teacher's box variance, before tau scaling."""
    if model_type == "LAPLACE":
        entropy = 1.0 + 0.5 * torch.log(4.0 * sigma_p)
        max_entropy = 1.0 + math.log(2.0)
    else:
        entropy = 0.5 * torch.log(2.0 * math.pi * math.e * sigma_p)
        max_entropy = 0.5 * math.log(2.0 * math.pi * math.e)
    return (1.0 - entropy / max_entropy) ** lam


def rpn_soft_cls_loss(objectness_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      anchor_mask: torch.Tensor, tau0: float, efl: bool,
                      lam0: float) -> torch.Tensor:
    """Unsupervised RPN classification loss, masked sum.

    target = softmax(t / tau0) collapsed to [p_bg, p_fg] (EFL-weighted); per anchor
    sum(target * -log(sigmoid([1 - o, o]) + 1e-9)), the reference's sigmoid(1 - o)
    form.
    """
    p = torch.softmax(teacher_logits / tau0, dim=-1)
    target = torch.stack([p[..., -1], p[..., :-1].sum(-1)], dim=-1)
    if efl:
        target = target * efl_class_weight(teacher_logits, lam0)[..., None]
    o = objectness_logits
    neg_log = -torch.log(torch.sigmoid(torch.stack([1.0 - o, o], dim=-1)) + 1e-9)
    return _masked_sum((target * neg_log).sum(-1), anchor_mask)


def kl_consistency_box_loss(mean_q: torch.Tensor, sigma_q_raw: torch.Tensor,
                            mean_p: torch.Tensor, sigma_p_raw: torch.Tensor,
                            mask: torch.Tensor, tau1: float, efl: bool, lam1: float,
                            model_type: str = "GUASSIAN",
                            reduction: str = "sum") -> torch.Tensor:
    """Teacher -> student box-distribution consistency.

    q is the student (mean, raw sigma), p the teacher (detached by the caller).
    sigma_p = sigmoid(raw) gives the EFL weight, then is scaled by tau1; Gaussian:
    0.5 log(sq / sp) - 0.5 + (sp + (mq - mp)^2) / (2 sq). ``mask`` (...,) selects
    rows; ``reduction`` 'sum' or 'mean' over the masked elements.
    """
    sigma_p = torch.sigmoid(sigma_p_raw)
    if efl:
        w = efl_box_weight(sigma_p, lam1, model_type)
    sigma_p = sigma_p * tau1
    sigma_q = torch.sigmoid(sigma_q_raw)
    if model_type == "LAPLACE":
        diff = torch.abs(mean_q - mean_p)
        loss = (torch.sqrt(sigma_p) * torch.exp(-diff / torch.sqrt(sigma_p))
                / torch.sqrt(sigma_q)
                + diff / torch.sqrt(sigma_q)
                + 0.5 * torch.log(sigma_q / sigma_p)
                - 1.0)
    else:
        loss = (0.5 * torch.log(sigma_q / sigma_p) - 0.5
                + (sigma_p + (mean_q - mean_p) ** 2) / (2.0 * sigma_q))
    if efl:
        loss = loss * w
    loss = torch.where(mask[..., None], loss, torch.zeros_like(loss))
    if reduction == "mean":
        n = torch.clamp(global_sum(mask.float().sum()) * loss.shape[-1], min=1.0)
        return loss.sum() / n
    return loss.sum()


def roi_soft_cls_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      valid: torch.Tensor, tau0: float, efl: bool,
                      lam0: float) -> torch.Tensor:
    """Unsupervised ROI classification loss: per row
    sum(softmax(t / tau0) [* EFL] * -log_softmax(s)), summed over valid rows / #valid."""
    neg_logp = -torch.log_softmax(student_logits, dim=-1)
    soft = torch.softmax(teacher_logits / tau0, dim=-1)
    if efl:
        soft = soft * efl_class_weight(teacher_logits, lam0)[..., None]
    return _masked_sum((soft * neg_logp).sum(-1), valid) / _count(valid)
