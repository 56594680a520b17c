"""Pluggable trainer hooks (the JAX package's ``engine/hooks.py``).

Mirrors detectron2's hook protocol exercised by ``PTrainer.build_hooks``
(``pt/engine/trainer.py:498-547``): objects with
``before_train / before_step / after_step / after_train``, registered on the
trainer and called in order (after_* in reverse order, like detectron2).

The default hook set: iteration timing, periodic writers (every 20), periodic
checkpointing, periodic dual eval of student and teacher, and the
``torch.profiler`` window. Users add hooks via ``trainer.register_hooks([...])``.

Over several ranks (``trainer.mesh``), every rank runs every hook, and each
decision that leads to a collective or to a save is the same on all of them:
metrics are summed over the ranks at the writer's cadence (``data_time`` is their
max), rank 0 alone evaluates and broadcasts what it decides from an evaluation
(the best checkpoint, the teacher's mAP drop), and the memory guard compares the
largest RSS of the ranks, so that all ranks save and exit together. Checkpoint
files are written by rank 0 (``checkpoint.save_checkpoint``).

Two detectron2 default hooks have no counterpart here, as in the JAX package:
``LRScheduler`` (:class:`ClippedSGD` reads its schedule at its own update count;
the writer still reports ``lr``) and ``PreciseBN`` (the VGG backbone and heads
have no BatchNorm).
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from collections import deque
from typing import Dict, Optional

import torch

from ..parallel.mesh import broadcast_values, host_max

logger = logging.getLogger("probabilisticteacher_torch")


class HookBase:
    """Base hook; ``self.trainer`` is set at registration."""

    trainer = None  # type: ignore

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Tracks seconds/iter (excluding the first, warm-up one) and emits ``it/s``
    through the storage (reference: detectron2 IterationTimer)."""

    def __init__(self, warmup_iters: int = 1):
        self._warmup = warmup_iters
        self._start: Optional[float] = None
        self._count = 0

    def before_step(self):
        if self._count == self._warmup:
            self._start = time.perf_counter()

    def after_step(self):
        self._count += 1
        n = self._count - self._warmup
        if self._start is not None and n > 0:
            self.trainer.storage.put_scalars(
                **{"it/s": n / (time.perf_counter() - self._start)})


class PeriodicWriter(HookBase):
    """Record the previous step's metrics and flush the writers every ``period``
    iters (reference: PeriodicWriter every 20, ``trainer.py:544-546``).

    The trainer starts each step's metrics on their way to the host as the step
    ends (``pending_metrics``, one stacked copy behind the step's kernels). This
    hook reads them one step late: the snapshot taken in ``before_step`` is the
    previous step's, so reading it waits for that step only, never for the one
    just queued, and the values are recorded under their own iteration. Only at
    the final iteration is the current step read, so the last write is not stale.
    """

    def __init__(self, period: int = 20):
        self.period = period
        # (iteration, metrics) of the PREVIOUS step
        self._prev = (-1, None)

    def before_step(self):
        t = self.trainer
        self._prev = (t.iter - 1, t.pending_metrics)

    def after_step(self):
        t = self.trainer
        it = t.iter
        final = it == t.max_iter - 1
        mit, metrics = (it, t.pending_metrics) if final else self._prev
        if metrics is None:
            return
        if mit % self.period == 0 or final:
            host = metrics.values(t.mesh)
            # max across ranks, like the reference (trainer.py:407-411)
            host["data_time"] = host_max(t.mesh, t.last_data_time)
            # "lr" in every write, like detectron2's LRScheduler hook: the value
            # the optimizer read at that iteration
            host["lr"] = float(t.state.optimizer.lr_schedule(mit))
            saved = t.storage.iter
            t.storage.iter = mit  # attribute to the step the values came from
            try:
                t.storage.put_scalars(**host)
                for w in t.writers:
                    w.write(t.storage)
            finally:
                t.storage.iter = saved

    def after_train(self):
        for w in self.trainer.writers:
            if hasattr(w, "close"):
                w.close()


class PeriodicCheckpointer(HookBase):
    """Save the ensemble TrainState every ``period`` iters (``trainer.py:522-527``)."""

    def __init__(self, period: int, keep: int = 100):
        self.period = period
        self.keep = keep

    def after_step(self):
        t = self.trainer
        nxt = t.iter + 1
        if self.period and nxt % self.period == 0:
            from ..checkpoint import save_checkpoint

            save_checkpoint(t.cfg.OUTPUT_DIR, t.state, keep=self.keep)
            if t.mesh.rank == 0:
                logger.info(f"Checkpoint saved at iter {nxt}")


class EvalHook(HookBase):
    """Periodic dual eval: student (suffixed) + teacher (plain keys: the headline
    metric tracks the teacher), on rank 0, as the reference does
    (``trainer.py:529-542``)."""

    def __init__(self, period: int):
        self.period = period

    def after_step(self):
        t = self.trainer
        nxt = t.iter + 1
        if self.period and nxt % self.period == 0 and t.mesh.rank == 0:
            t.eval_and_log(suffix="_student", model=t.state.student)
            t.eval_and_log(suffix="", model=t.state.teacher)


class BestCheckpointer(HookBase):
    """Keep the checkpoint with the best value of ``metric`` (default: the
    teacher's headline mAP50), like detectron2's BestCheckpointer. Runs right
    after EvalHook refreshes the metric; saves to ``model_best`` in OUTPUT_DIR.
    Mean-teacher curves can peak mid-schedule, so the last checkpoint can be far
    from the best one.
    """

    def __init__(self, eval_period: int, metric: str = "mAP50", mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(mode)
        self.period = eval_period
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.best: Optional[float] = None

    def _marker_path(self) -> str:
        return os.path.join(self.trainer.cfg.OUTPUT_DIR, "model_best.json")

    def before_train(self):
        # persist the best value across restarts (--supervise/--resume): without
        # this, the first post-restart eval would overwrite model_best even when worse
        path = self._marker_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("metric") == self.metric:
                    self.best = float(rec["best"])
                    logger.info(f"BestCheckpointer resumed best {self.metric}={self.best}")
            except (OSError, ValueError, KeyError):
                pass

    def _check(self):
        t = self.trainer
        # only rank 0 holds eval metrics (EvalHook is rank 0's); it decides, and the
        # decision is broadcast so that every rank enters the save together
        val = t.storage.latest().get(self.metric) if t.mesh.rank == 0 else None
        improved = val is not None and (self.best is None
                                        or self.sign * val > self.sign * self.best)
        flag, bval = broadcast_values(t.mesh, [float(improved), val or 0.0])
        if not flag:
            return
        self.best = val = bval
        from ..checkpoint import save_checkpoint

        path = save_checkpoint(t.cfg.OUTPUT_DIR, t.state, keep=0, name="model_best")
        if t.mesh.rank == 0:
            with open(self._marker_path(), "w") as f:
                json.dump({"metric": self.metric, "best": val, "step": int(t.state.step)}, f)
            logger.info(f"New best {self.metric}={val:.3f} -> {path}")

    def before_step(self):
        # runs at the iteration AFTER an eval boundary: after_* hooks run in
        # reverse registration order, so checking here (instead of after_step)
        # makes the fresh eval value visible regardless of registration order
        if self.period and self.trainer.iter > 0 and self.trainer.iter % self.period == 0:
            self._check()

    def after_train(self):
        self._check()  # cover an eval landing on the final iteration


class MemoryGuardHook(HookBase):
    """Checkpoint-and-exit before the host OOM killer strikes.

    Long runs can exhaust HOST memory through leaks outside our control. The
    kernel OOM killer gives no chance to save state; this hook watches
    /proc/self/status VmRSS every ``period`` iters and, above ``limit_gb``, saves a
    checkpoint and exits with code 75 (EX_TEMPFAIL) so a supervisor
    (``train_net.py --supervise``) can relaunch with ``--resume``. The process
    boundary is what reclaims the leaked memory.
    """

    EXIT_CODE = 75

    def __init__(self, limit_gb: float, period: int = 50):
        self.limit_kb = int(limit_gb * 1024 * 1024)
        self.period = period

    @staticmethod
    def rss_kb() -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0

    def after_step(self):
        t = self.trainer
        if not self.limit_kb or (t.iter + 1) % self.period:
            return
        # every rank compares the largest RSS of all ranks, so all of them save and
        # exit 75 together instead of one dying while the others wait on it
        rss = host_max(t.mesh, self.rss_kb())
        if rss <= self.limit_kb:
            return
        logger.warning(
            f"Host RSS {rss / 1e6:.1f} GB exceeds the {self.limit_kb / 1e6:.1f} GB "
            f"guard at iter {t.iter + 1}; checkpointing and exiting 75 for restart")
        from ..checkpoint import save_checkpoint

        save_checkpoint(t.cfg.OUTPUT_DIR, t.state)
        for w in t.writers:
            if hasattr(w, "close"):
                w.close()
        raise SystemExit(self.EXIT_CODE)


class DivergenceGuardHook(HookBase):
    """Abort the run on a non-finite total loss (reference behavior parity).

    The reference hard-fails a diverged run: detectron2's ``_write_metrics``
    raises on a non-finite total loss (``pt/engine/trainer.py:394-429``). Losses
    reach the host at writer cadence, so the check runs there: this hook is
    registered BEFORE PeriodicWriter, which makes its ``after_step`` run AFTER the
    writer's (reverse order), reading the freshly written total_loss. A diverged
    run stops within one write period, raising the FloatingPointError the
    reference raises.
    """

    def __init__(self):
        self._checked_iter = -1

    def after_step(self):
        t = self.trainer
        it = t.storage.iter_of("total_loss")
        if it <= self._checked_iter:
            return
        self._checked_iter = it
        val = t.storage.latest()["total_loss"]
        if not math.isfinite(val):
            raise FloatingPointError(
                f"total_loss={val} at iteration {it}: the run has diverged "
                f"(the reference raises here too — detectron2 _write_metrics). "
                f"Consider lowering SOLVER.BASE_LR or, at the burn-in boundary, "
                f"setting UNSUPNET.UNSUP_LOSS_WARMUP_ITERS. "
                f"Set UNSUPNET.ABORT_ON_NONFINITE False to disable this guard.")


class TeacherHealthHook(HookBase):
    """Collapse detector for the mutual phase.

    Teacher collapse is silent: losses stay normal while the teacher's mAP falls.
    Two early signals are computed every period:

    - ``num_pseudo_boxes`` cliff: the fresh written value drops more than
      ``pseudo_drop`` (default 50%) below the trailing median of recent writes;
    - teacher eval drop: the headline ``mAP50`` falls more than ``map_drop``
      points between consecutive evals.

    On trigger: a WARNING naming ``UNSUPNET.UNSUP_LOSS_WARMUP_ITERS`` (the rescue
    lever), a ``health/collapse_flag`` scalar in the metrics stream, and a
    one-time forensic checkpoint ``model_health`` holding the state at detection.
    The mAP watch reads the plain ``mAP50`` key (a single test dataset). Over
    several ranks the pseudo-box metric is the same on every rank (summed at the
    writer), so that watch needs no coordination; the mAP is rank 0's and its
    decision is broadcast.
    """

    def __init__(self, eval_period: int, pseudo_drop: float = 0.5,
                 map_drop: float = 15.0, window: int = 25, min_history: int = 5):
        self.eval_period = eval_period
        self.pseudo_drop = pseudo_drop
        self.map_drop = map_drop
        self.min_history = min_history
        self._pseudo_hist = deque(maxlen=window)
        self._last_pseudo_iter = -1
        self._prev_map: Optional[float] = None
        self._saved = False

    def _trigger(self, reason: str):
        t = self.trainer
        logger.warning(
            f"TEACHER HEALTH at iter {t.iter}: {reason}. The run matches the "
            f"silent-collapse signature; the rescue lever is "
            f"UNSUPNET.UNSUP_LOSS_WARMUP_ITERS (restart from the pre-collapse "
            f"checkpoint with a boundary ramp).")
        t.storage.put_scalars(**{"health/collapse_flag": 1.0})
        if not self._saved:
            self._saved = True
            from ..checkpoint import save_checkpoint

            path = save_checkpoint(t.cfg.OUTPUT_DIR, t.state, keep=0, name="model_health")
            logger.warning(f"Forensic health checkpoint saved to {path}")

    def after_step(self):
        t = self.trainer
        if self.pseudo_drop > 0:
            it = t.storage.iter_of("num_pseudo_boxes")
            if it > self._last_pseudo_iter:
                self._last_pseudo_iter = it
                val = t.storage.latest()["num_pseudo_boxes"]
                hist = self._pseudo_hist
                if len(hist) >= self.min_history:
                    med = sorted(hist)[len(hist) // 2]
                    if med > 0 and val < (1.0 - self.pseudo_drop) * med:
                        self._trigger(
                            f"num_pseudo_boxes cliff: {val:.1f} is "
                            f"{100 * (1 - val / med):.0f}% below the trailing "
                            f"median {med:.1f}")
                hist.append(val)
        if self.map_drop <= 0 or not self.eval_period:
            return
        # eval landed this step (EvalHook fires at (iter+1) % period == 0 and
        # runs before us: registration order)
        if (t.iter + 1) % self.eval_period:
            return
        # rank 0 holds the eval; every rank takes this branch together, and rank 0's
        # decision is broadcast so that all of them enter the forensic save
        hit, prev, cur = False, 0.0, 0.0
        if t.mesh.rank == 0:
            latest = t.storage.latest().get("mAP50")
            if latest is not None:
                prev, cur = self._prev_map, latest
                hit = (t.storage.iter_of("mAP50") >= 0 and prev is not None
                       and prev - cur > self.map_drop)
                self._prev_map = latest
        flag, prev, cur = broadcast_values(t.mesh, [float(hit), prev or 0.0, cur])
        if flag:
            self._trigger(f"teacher mAP50 fell {prev:.1f} -> {cur:.1f} "
                          f"(> {self.map_drop} points) between evals")


class ProfilerHook(HookBase):
    """``torch.profiler`` window [START_STEP, START_STEP + NUM_STEPS) (cfg.PROFILER);
    writes a Chrome trace, ``trace.json``, under ``output_dir``."""

    def __init__(self, start_step: int, num_steps: int, output_dir: str):
        self.start = start_step
        self.stop = start_step + num_steps
        self.outdir = output_dir
        self._prof: Optional[torch.profiler.profile] = None

    def before_step(self):
        if self.trainer.iter == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.trainer.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def after_step(self):
        if self._prof is not None and self.trainer.iter + 1 == self.stop:
            if self.trainer.device.type == "cuda":
                torch.cuda.synchronize(self.trainer.device)
            self._prof.stop()
            os.makedirs(self.outdir, exist_ok=True)
            path = os.path.join(self.outdir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            logger.info(f"Profiler trace written to {path}")


class LossEvalHook(HookBase):
    """Periodic validation loss on a labeled set: the reference defines this hook
    but never registers it (``pt/engine/hooks.py:24-133``); an opt-in utility."""

    def __init__(self, period: int, dataset_name: str, max_batches: int = 20):
        self.period = period
        self.dataset = dataset_name
        self.max_batches = max_batches

    def after_step(self):
        t = self.trainer
        if self.period and (t.iter + 1) % self.period == 0:
            vals: Dict[str, float] = t.validation_loss(
                t.state.student, self.dataset, self.max_batches)
            t.storage.put_scalars(**vals)
            logger.info(f"validation loss: {vals}")
