"""Train steps: burn-in and mutual learning (counterpart of the JAX
``engine/steps.py``).

- burn-in: strong augmentation of the labeled images -> scale jitter over the
  (strong + weak) views -> supervised losses -> clipped SGD update;
- mutual: EMA teacher update (a full copy at ``BURN_UP_STEP``, then every
  ``TEACHER_UPDATE_ITER`` steps) -> the teacher's pseudo-labels on the weak
  unlabeled images -> strong augmentation and scale jitter of both views, with
  the jittered pseudo boxes detached -> the fused student losses (optionally
  ramping the unsupervised weight over ``UNSUP_LOSS_WARMUP_ITERS``) -> one
  backward -> clipped SGD update.

The student and the teacher are two :class:`PTDetector` modules; the steps update
them and the optimizer in place and return the state with its step advanced and
the metrics as detached tensors (no host synchronization). Every random number of
a step comes from a :class:`StepDraws` value, or is drawn from a
``torch.Generator``. A step's optional ``mark`` is called with the name of each
stage as it ends ("ema", "pseudo_labels", "augment", "forward", "backward",
"grad_all_reduce" over several ranks, "optimizer"), so that a profiler can put CUDA
events between them.

Data parallel (``mesh`` of W ranks, ``parallel/mesh.py``): each rank holds 1/W of
the global batch, and a step gives the losses, metrics and update of one process
over the whole batch. The draws are the global batch's (drawn from the generator
every rank seeds alike, or handed in), and each rank keeps its rows; the labeled
rows keep the fused [strong N_l, weak N_l] order, so a rank's labeled rows are two
slices. The losses' normalizers count the global batch, each metric is the rank's
share of the global value (a SUM over the ranks gives it), and the gradients are
summed over the ranks before the clipped update. The EMA runs on identical
replicas and needs no communication.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..data.device_aug import AugDraws, draw_aug, draw_jitter, scale_jitter, strong_augment
from ..modeling.detector import LossDraws, PTDetector
from ..ops.sampling import RowDraws, SampleDraws
from ..parallel.mesh import Mesh, all_reduce_grads, global_counts, global_sum
from ..solver import ClippedSGD
from ..structures import GroundTruth, ImageBatch, PseudoLabels


class StepDraws(NamedTuple):
    """Every random number of one step.

    ``jitter_l`` holds one ratio per jittered labeled image: 2 N_l in burn-in
    (the strong and the weak views are jittered together), N_l in a mutual step
    (the strong view only). ``loss`` samples the 2 N_l labeled rows (or is a
    generator, or a rank's share of its draws). ``aug_u`` and ``jitter_u`` are for
    the unlabeled images of a mutual step.
    """

    aug_l: AugDraws
    jitter_l: torch.Tensor
    loss: Union[LossDraws, torch.Generator, RowDraws]
    aug_u: Optional[AugDraws] = None
    jitter_u: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    step: int                 # the iteration about to run
    student: PTDetector
    teacher: PTDetector
    optimizer: ClippedSGD


def create_train_state(student: PTDetector, optimizer: ClippedSGD) -> TrainState:
    """A fresh state at step 0; the teacher starts as a copy of the student."""
    teacher = copy.deepcopy(student).requires_grad_(False)
    return TrainState(0, student, teacher, optimizer)


def _sum_losses(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the entries whose key starts with ``loss`` (the rest are statistics)."""
    return sum(v for k, v in d.items() if k.startswith("loss"))


@torch.no_grad()
def ema_update(teacher: PTDetector, student: PTDetector, keep_rate: float) -> None:
    """teacher <- student * (1 - keep) + teacher * keep, in place; keep in f32."""
    keep = np.float32(keep_rate)
    one_minus = float(np.float32(1.0) - keep)
    for t, s in zip(teacher.parameters(), student.parameters()):
        t.copy_(s * one_minus + t * float(keep))


def _no_mark(stage: str) -> None:
    pass


def _cat_gt(a: GroundTruth, b: GroundTruth) -> GroundTruth:
    return GroundTruth(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def _rank_rows(mesh: Mesh, n: int, blocks: int) -> torch.Tensor:
    """Global row indices of this rank's n rows in each of ``blocks`` consecutive
    blocks of n W rows."""
    total = n * mesh.world_size
    own = torch.arange(mesh.rank * n, (mesh.rank + 1) * n)
    return torch.cat([own + b * total for b in range(blocks)])


def _rank_share(draws: StepDraws, mesh: Mesh, n_l: int, n_u: int,
                jitter_blocks: int) -> StepDraws:
    """This rank's rows of the global batch's draws: labeled images, the jittered
    labeled views (``jitter_blocks`` 2 in burn-in: strong and weak), the 2 N_l
    labeled rows of the loss, and the unlabeled images."""
    if not mesh.distributed:
        return draws

    def take(x, rows):
        return None if x is None else x[rows.to(x.device)]

    rows_l, rows_u = _rank_rows(mesh, n_l, 1), _rank_rows(mesh, n_u, 1)
    rows_2l = _rank_rows(mesh, n_l, 2)
    loss = draws.loss
    if isinstance(loss, torch.Generator):
        loss = RowDraws(loss, rows_2l, 2 * n_l * mesh.world_size)
    else:
        loss = LossDraws(*(SampleDraws(*(take(u, rows_2l) for u in sd)) for sd in loss))
    return StepDraws(AugDraws(*(take(x, rows_l) for x in draws.aug_l)),
                     take(draws.jitter_l, _rank_rows(mesh, n_l, jitter_blocks)), loss,
                     None if draws.aug_u is None
                     else AugDraws(*(take(x, rows_u) for x in draws.aug_u)),
                     take(draws.jitter_u, rows_u))


def make_train_steps(cfg, detector: PTDetector,
                     mesh: Optional[Mesh] = None) -> Tuple[Callable, Callable]:
    """(burnin_step, mutual_step) for ``cfg``; ``detector`` gives the architecture and
    ``mesh`` the data-parallel group (one process when None)."""
    mesh = mesh or Mesh(0, 1, detector.device)
    world = mesh.world_size
    arch = detector.arch
    pix_dtype = detector.dtype           # bf16 pixel and augmentation chain under AMP
    w_sup = float(cfg.UNSUPNET.SOURCE_LOSS_WEIGHT)
    w_unsup = float(cfg.UNSUPNET.TARGET_UNSUP_LOSS_WEIGHT)
    burn_up = int(cfg.UNSUPNET.BURN_UP_STEP)
    unsup_warmup = int(cfg.UNSUPNET.UNSUP_LOSS_WARMUP_ITERS)
    ema_keep = float(cfg.UNSUPNET.EMA_KEEP_RATE)
    teacher_update_iter = int(cfg.UNSUPNET.TEACHER_UPDATE_ITER)

    def _update(state: TrainState, total: torch.Tensor, losses: Dict[str, torch.Tensor],
                mark: Callable[[str], None]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mark("forward")
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        if mesh.distributed:
            all_reduce_grads(mesh, (p for g in state.optimizer.param_groups
                                    for p in g["params"]))
            mark("grad_all_reduce")
        state.optimizer.step()
        mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = _sum_losses(metrics)
        state.step += 1
        return state, metrics

    def burnin_step(state: TrainState, limg: ImageBatch, lgt: GroundTruth,
                    draws: Union[StepDraws, torch.Generator],
                    mark: Callable[[str], None] = _no_mark):
        """Source-only supervised step on the strong and weak views."""
        n = limg.image.shape[0]
        dev = limg.image.device
        if isinstance(draws, torch.Generator):
            draws = StepDraws(draw_aug(n * world, draws, dev),
                              draw_jitter(2 * n * world, draws, dev), draws)
        draws = _rank_share(draws, mesh, n, 0, 2)
        strong = strong_augment(limg.image, draws.aug_l, pix_dtype)
        images = torch.cat([strong, limg.image.to(pix_dtype)], dim=0)
        hw = torch.cat([limg.image_hw, limg.image_hw], dim=0)
        gt = _cat_gt(lgt, lgt)
        # extend, then resize: the jitter applies to both views
        images, jboxes = scale_jitter(images, hw, gt.boxes, arch.pixel_mean, draws.jitter_l,
                                      pix_dtype)
        mark("augment")
        with global_counts(mesh):
            losses = state.student.supervised_losses(ImageBatch(images, hw),
                                                     gt._replace(boxes=jboxes), draws.loss)
        return _update(state, _sum_losses(losses), losses, mark)

    def mutual_step(state: TrainState, limg: ImageBatch, lgt: GroundTruth, uimg: ImageBatch,
                    draws: Union[StepDraws, torch.Generator],
                    mark: Callable[[str], None] = _no_mark):
        """Mutual-learning step."""
        n_l, n_u = limg.image.shape[0], uimg.image.shape[0]
        dev = limg.image.device
        if isinstance(draws, torch.Generator):
            draws = StepDraws(draw_aug(n_l * world, draws, dev),
                              draw_jitter(n_l * world, draws, dev), draws,
                              draw_aug(n_u * world, draws, dev),
                              draw_jitter(n_u * world, draws, dev))
        draws = _rank_share(draws, mesh, n_l, n_u, 1)
        # the teacher moves before it labels: a full copy at the boundary, then EMA
        step = state.step
        if step == burn_up:
            keep = 0.0
        elif (step - burn_up) % teacher_update_iter == 0:
            keep = ema_keep
        else:
            keep = 1.0
        ema_update(state.teacher, state.student, keep)
        mark("ema")
        pseudo = state.teacher.pseudo_labels(uimg)
        mark("pseudo_labels")

        # labeled: the jittered strong view and the plain weak view
        strong_l = strong_augment(limg.image, draws.aug_l, pix_dtype)
        strong_l, lboxes_j = scale_jitter(strong_l, limg.image_hw, lgt.boxes, arch.pixel_mean,
                                          draws.jitter_l, pix_dtype)
        batch_l = ImageBatch(torch.cat([strong_l, limg.image.to(pix_dtype)], dim=0),
                             torch.cat([limg.image_hw, limg.image_hw], dim=0))
        gt_l = _cat_gt(lgt._replace(boxes=lboxes_j), lgt)

        # unlabeled: the jittered strong view, with the pseudo boxes moved alike
        strong_u = strong_augment(uimg.image, draws.aug_u, pix_dtype)
        strong_u, pboxes_j = scale_jitter(strong_u, uimg.image_hw, pseudo.boxes,
                                          arch.pixel_mean, draws.jitter_u, pix_dtype)
        pseudo_j = PseudoLabels(pboxes_j.detach(), pseudo.logits, pseudo.sigma, pseudo.valid)
        batch_u = ImageBatch(strong_u, uimg.image_hw)
        mark("augment")

        w_u = w_unsup
        if unsup_warmup > 0:   # opt-in ramp; 0 keeps the reference's full weight
            w_u = w_unsup * float(np.clip(np.float32(step - burn_up) / np.float32(unsup_warmup),
                                          0.0, 1.0))
        with global_counts(mesh):
            sup, unsup = state.student.student_losses(batch_l, gt_l, batch_u, pseudo_j,
                                                      draws.loss)
            # mean valid pseudo boxes per image (the reference's num_proposal_output)
            num_pseudo = pseudo.valid.float().sum() / global_sum(n_u)
        losses = {k + "_sup": v for k, v in sup.items()}
        losses.update({k + "_unsup": v for k, v in unsup.items()})
        total = w_sup * _sum_losses(sup) + w_u * _sum_losses(unsup)
        state, metrics = _update(state, total, losses, mark)
        metrics["num_pseudo_boxes"] = num_pseudo
        return state, metrics

    return burnin_step, mutual_step
