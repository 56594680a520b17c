"""The train steps of Probabilistic Teacher in plain PyTorch: burn-in and mutual
learning, the EMA teacher and the clipped SGD update.

A frozen copy of ``probabilisticteacher_torch/engine/steps.py`` and ``solver.py`` as
they stood when the benchmark was written, for one process: the same order of
stages, the same draws from a ``torch.Generator`` in the same order, the same
schedule, clip, coupled weight decay and momentum. Everything computes in f32.
"""

from __future__ import annotations

import copy
import re
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .aug import draw_aug, draw_jitter, scale_jitter, strong_augment
from .model import GroundTruth, ImageBatch, PseudoLabels, PTDetector

_F = np.float32


def warmup_factor(method: str, it, warmup_iters: int, factor: float) -> np.float32:
    it = _F(it)
    if method == "constant":
        return _F(factor) if it < warmup_iters else _F(1.0)
    if method == "linear":
        alpha = min(it / _F(max(warmup_iters, 1)), _F(1.0))
        return _F(factor) * (_F(1.0) - alpha) + alpha if it < warmup_iters else _F(1.0)
    raise ValueError(f"Unknown warmup method: {method}")


def multistep_lr(solver: Dict) -> Callable[[int], float]:
    """WarmupMultiStepLR: step -> lr, in f32."""
    base_lr, gamma = _F(solver["base_lr"]), _F(solver["gamma"])
    steps = tuple(int(x) for x in solver["steps"])

    def sched(it):
        n_passed = _F(sum(1 for m in steps if _F(it) >= m))
        return float(base_lr * warmup_factor(solver["warmup_method"], it,
                                             int(solver["warmup_iters"]),
                                             float(solver["warmup_factor"]))
                     * gamma ** n_passed)
    return sched


def is_frozen(name: str, freeze_at: int) -> bool:
    m = re.match(r"backbone\.block(\d+)_", name)
    return m is not None and int(m.group(1)) <= freeze_at


class ClippedSGD:
    """Clip by global norm -> coupled weight decay -> SGD with momentum; the
    schedule is read at the update count."""

    def __init__(self, params: List[torch.Tensor], lr_schedule: Callable[[int], float],
                 momentum: float, weight_decay: float, clip_norm: Optional[float],
                 count: int = 0):
        self.params = params
        self.lr_schedule = lr_schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = count
        self.trace = [torch.zeros_like(p) for p in params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            c = self.clip_norm
            grads = [torch.where(norm < c, g, (g / norm.to(g.dtype)) * c) for g in grads]
        lr = self.lr_schedule(self.count)
        for p, g, trace in zip(self.params, grads, self.trace):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            trace.copy_(g + self.momentum * trace)
            p.add_(trace * -lr)
        self.count += 1


class State(NamedTuple):
    student: PTDetector
    teacher: PTDetector
    optimizer: ClippedSGD


def build_state(student: PTDetector, solver: Dict, freeze_at: int, start_iter: int) -> State:
    """The student, a teacher copied from it, and the optimizer at update count
    ``start_iter`` with zero momentum."""
    teacher = copy.deepcopy(student).requires_grad_(False)
    params = [p for n, p in student.named_parameters() if not is_frozen(n, freeze_at)]
    clip = float(solver["clip_value"]) if solver["clip_enabled"] else None
    opt = ClippedSGD(params, multistep_lr(solver), float(solver["momentum"]),
                     float(solver["weight_decay"]), clip, count=start_iter)
    return State(student, teacher, opt)


def _sum_losses(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v for k, v in d.items() if k.startswith("loss"))


@torch.no_grad()
def ema_update(teacher: PTDetector, student: PTDetector, keep_rate: float) -> None:
    keep = np.float32(keep_rate)
    one_minus = float(np.float32(1.0) - keep)
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(s * one_minus + t * float(keep))


def _cat_gt(a: GroundTruth, b: GroundTruth) -> GroundTruth:
    return GroundTruth(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def _update(state: State, total: torch.Tensor,
            losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    state.optimizer.zero_grad()
    total.backward()
    state.optimizer.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = _sum_losses(metrics)
    return metrics


def burnin_step(state: State, limg: ImageBatch, lgt: GroundTruth, gen: torch.Generator,
                pixel_mean) -> Dict[str, torch.Tensor]:
    """Source-only supervised step on the strong and weak views."""
    n = limg.image.shape[0]
    dev = limg.image.device
    aug, jitter = draw_aug(n, gen, dev), draw_jitter(2 * n, gen, dev)
    strong = strong_augment(limg.image, aug)
    images = torch.cat([strong, limg.image.float()], dim=0)
    hw = torch.cat([limg.image_hw, limg.image_hw], dim=0)
    gt = _cat_gt(lgt, lgt)
    images, jboxes = scale_jitter(images, hw, gt.boxes, pixel_mean, jitter)
    losses = state.student.supervised_losses(ImageBatch(images, hw),
                                             gt._replace(boxes=jboxes), gen)
    return _update(state, _sum_losses(losses), losses)


def mutual_step(state: State, step: int, burn_up: int, cfg: Dict, limg: ImageBatch,
                lgt: GroundTruth, uimg: ImageBatch, gen: torch.Generator, pixel_mean,
                on_pseudo: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Mutual-learning step ``step``: the teacher moves (a full copy at ``burn_up``,
    then EMA), labels the weak unlabeled view, and the student learns from both."""
    n_l, n_u = limg.image.shape[0], uimg.image.shape[0]
    dev = limg.image.device
    aug_l, jit_l = draw_aug(n_l, gen, dev), draw_jitter(n_l, gen, dev)
    aug_u, jit_u = draw_aug(n_u, gen, dev), draw_jitter(n_u, gen, dev)
    if step == burn_up:
        keep = 0.0
    elif (step - burn_up) % int(cfg["teacher_update_iter"]) == 0:
        keep = float(cfg["ema_keep_rate"])
    else:
        keep = 1.0
    ema_update(state.teacher, state.student, keep)
    pseudo, det = state.teacher.pseudo_labels_and_detections(uimg)
    if on_pseudo is not None:
        on_pseudo(det)

    strong_l = strong_augment(limg.image, aug_l)
    strong_l, lboxes_j = scale_jitter(strong_l, limg.image_hw, lgt.boxes, pixel_mean, jit_l)
    batch_l = ImageBatch(torch.cat([strong_l, limg.image.float()], dim=0),
                         torch.cat([limg.image_hw, limg.image_hw], dim=0))
    gt_l = _cat_gt(lgt._replace(boxes=lboxes_j), lgt)
    strong_u = strong_augment(uimg.image, aug_u)
    strong_u, pboxes_j = scale_jitter(strong_u, uimg.image_hw, pseudo.boxes, pixel_mean, jit_u)
    pseudo_j = PseudoLabels(pboxes_j.detach(), pseudo.logits, pseudo.sigma, pseudo.valid)
    batch_u = ImageBatch(strong_u, uimg.image_hw)

    sup, unsup = state.student.student_losses(batch_l, gt_l, batch_u, pseudo_j, gen)
    num_pseudo = pseudo.valid.float().sum() / n_u
    losses = {k + "_sup": v for k, v in sup.items()}
    losses.update({k + "_unsup": v for k, v in unsup.items()})
    total = (float(cfg["source_loss_weight"]) * _sum_losses(sup)
             + float(cfg["target_unsup_loss_weight"]) * _sum_losses(unsup))
    metrics = _update(state, total, losses)
    metrics["num_pseudo_boxes"] = num_pseudo
    return metrics
