"""Learning-rate schedules and the optimizer (counterpart of the JAX ``solver.py``).

- Schedules: WarmupMultiStepLR, WarmupCosineLR and WarmupTwoStageMultiStepLR
  with FACTOR_LIST, as step -> lr functions computed in f32 like the JAX ones.
- :class:`ClippedSGD`: the JAX package's optax chain, in order: clip by global
  norm as optax does it (``g`` unchanged when ``|g| < c``, else ``(g / |g|) * c``;
  the norm covers the trainable parameters only), then coupled weight decay
  ``g + wd * p`` on every trainable tensor (biases and ``anchor_wh`` included),
  then SGD with momentum (``trace = g + m * trace``, ``p += -lr * trace``) at the
  schedule's value for the optimizer's own update count. A parameter without a
  gradient counts as a zero gradient, so weight decay still moves it.
- ``MODEL.BACKBONE.FREEZE_AT``: VGG blocks 1..freeze_at are not given to the
  optimizer, so they get neither update nor decay.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

_F = np.float32


def warmup_factor(method: str, it, warmup_iters: int, factor: float) -> np.float32:
    """detectron2's warmup factor at iteration ``it``, in f32."""
    it = _F(it)
    if method == "constant":
        return _F(factor) if it < warmup_iters else _F(1.0)
    if method == "linear":
        alpha = min(it / _F(max(warmup_iters, 1)), _F(1.0))
        return _F(factor) * (_F(1.0) - alpha) + alpha if it < warmup_iters else _F(1.0)
    raise ValueError(f"Unknown warmup method: {method}")


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """step -> lr from ``cfg.SOLVER``."""
    s = cfg.SOLVER
    name = s.LR_SCHEDULER_NAME
    base_lr = _F(s.BASE_LR)
    steps = tuple(int(x) for x in s.STEPS)
    gamma = _F(s.GAMMA)
    wf0 = float(s.WARMUP_FACTOR)
    wi = int(s.WARMUP_ITERS)
    wm = s.WARMUP_METHOD

    if name == "WarmupMultiStepLR":
        def sched(it):
            n_passed = _F(sum(1 for m in steps if _F(it) >= m))
            return float(base_lr * warmup_factor(wm, it, wi, wf0) * gamma ** n_passed)
    elif name == "WarmupCosineLR":
        max_iter = int(s.MAX_ITER)

        def sched(it):
            cos = _F(0.5) * (_F(1.0) + np.cos(_F(math.pi) * _F(it) / _F(max_iter)))
            return float(base_lr * warmup_factor(wm, it, wi, wf0) * cos)
    elif name == "WarmupTwoStageMultiStepLR":
        factors = tuple(_F(f) for f in s.FACTOR_LIST)
        if len(factors) != len(steps) + 1:
            raise ValueError("FACTOR_LIST must be len(STEPS) + 1")

        def sched(it):
            idx = sum(1 for m in steps if _F(it) >= m)
            return float(base_lr * warmup_factor(wm, it, wi, wf0) * factors[idx])
    else:
        raise ValueError(f"Unknown LR scheduler: {name}")
    return sched


def auto_scale_config(cfg):
    """detectron2 ``auto_scale_workers``: when SOLVER.REFERENCE_BATCH_SIZE > 0 and the
    labeled batch differs, scale the LR linearly and the iteration counts inversely."""
    ref = int(cfg.SOLVER.get("REFERENCE_BATCH_SIZE", 0) or 0)
    bs = int(cfg.SOLVER.IMG_PER_BATCH_LABEL)
    if ref <= 0 or bs == ref:
        return cfg
    scale = bs / ref
    frozen = object.__getattribute__(cfg, cfg.IMMUTABLE)
    if frozen:
        cfg.defrost()
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
    cfg.SOLVER.CHECKPOINT_PERIOD = int(round(cfg.SOLVER.CHECKPOINT_PERIOD / scale))
    cfg.UNSUPNET.BURN_UP_STEP = int(round(cfg.UNSUPNET.BURN_UP_STEP / scale))
    if frozen:
        cfg.freeze()
    return cfg


def is_frozen(name: str, freeze_at: int) -> bool:
    """True for the parameters of VGG blocks 1..freeze_at (``backbone.blockI_convJ.*``)."""
    m = re.match(r"backbone\.block(\d+)_", name)
    return m is not None and int(m.group(1)) <= freeze_at


class ClippedSGD(torch.optim.Optimizer):
    """Clip by global norm -> coupled weight decay -> SGD with momentum, the optax
    chain of the JAX package. ``lr_schedule`` is read at the update count, which
    starts at 0 and counts :meth:`step` calls."""

    def __init__(self, params: Iterable[torch.Tensor], lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, dict(momentum=momentum, weight_decay=weight_decay,
                                      nesterov=nesterov))
        self.lr_schedule = lr_schedule
        self.clip_norm = clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            c = self.clip_norm
            grads = [torch.where(norm < c, g, (g / norm.to(g.dtype)) * c) for g in grads]
        lr = self.lr_schedule(self.count)
        i = 0
        for group in self.param_groups:
            m, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                g = grads[i]
                i += 1
                if wd > 0:
                    g = g + wd * p
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.copy_(g + m * trace)
                upd = g + m * trace if group["nesterov"] else trace
                p.add_(upd * -lr)
        self.count += 1

    def state_dict(self):
        """The momentum traces and hyperparameters, plus the update count that the
        schedule reads, so that a resumed run continues the schedule."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def build_optimizer(cfg, model: nn.Module) -> ClippedSGD:
    """The optimizer of ``cfg.SOLVER`` over ``model``'s trainable parameters."""
    s = cfg.SOLVER
    freeze_at = int(cfg.MODEL.BACKBONE.FREEZE_AT)
    params = [p for name, p in model.named_parameters() if not is_frozen(name, freeze_at)]
    return ClippedSGD(
        params, build_lr_schedule(cfg), momentum=float(s.MOMENTUM),
        weight_decay=float(s.WEIGHT_DECAY),
        clip_norm=float(s.CLIP_GRADIENTS.CLIP_VALUE) if s.CLIP_GRADIENTS.ENABLED else None,
        nesterov=bool(s.NESTEROV))
