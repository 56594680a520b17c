"""PTrainer: the training engine (burn-in -> mutual learning), hooks, eval, checkpoints.

The port of the JAX package's ``engine/trainer.py`` (itself a re-architecture of
the reference ``PTrainer``, ``pt/engine/trainer.py:67-603``), with the same
methods and behaviour:

- burn-in until UNSUPNET.BURN_UP_STEP, then mutual learning (``run_step``), each
  iteration one call of ``engine/steps.py``'s ``burnin_step`` or ``mutual_step``;
- teacher copy at the boundary, EMA 0.9996 after (inside the mutual step);
- periodic console/JSON writers (every 20), checkpoints (CHECKPOINT_PERIOD, holding
  teacher + student + optimizer + step like EnsembleTSModel), eval of BOTH student
  and teacher every TEST.EVAL_PERIOD (``build_hooks``, ``trainer.py:498-547``);
- ``resume_or_load`` with a last_checkpoint marker (``trainer.py:466-496``);
- config dump into OUTPUT_DIR for provenance (``train_net.py:54-55``).

Each process is one rank on one device: the card unless ``MODEL.DEVICE`` is
``"cpu"`` (any other value, the config's default ``"tpu"`` included, means the
card, and its absence raises). A launcher's environment (``torchrun``, or the
CLI's ``--num-gpus``) makes it one of W data-parallel ranks (``parallel/mesh.py``):
each loads 1/W of the global batch with its own sample stream (``SEED + 9973
rank``), the steps reduce counts and gradients over the ranks, and rank 0 alone
writes metrics, the config dump and checkpoint files and runs the evaluations,
which hold no collective (JAX ``trainer.py:74``, ``:136``, ``:200-205``, ``:323``).
W must divide both batch sizes (``PARALLEL.ALLOW_DEVICE_SUBSET`` trains on the
largest rank count that does instead). Host batches reach the card through the
CUDA-stream double buffer of ``parallel/prefetch.py``. Each step's random draws
come from one ``torch.Generator`` on the device, reseeded per iteration from
``SEED + 17`` and the iteration (the JAX package folds the iteration into its
``SEED + 17`` key), so a resumed run draws what an uninterrupted one would, and
every rank draws the global batch's numbers. ``COMPILE_CACHE_DIR`` is ignored:
there is no XLA compile to cache.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import (latest_checkpoint, load_checkpoint, load_vgg_caffe, load_weights,
                          save_checkpoint)
from ..config import Arch
from ..data.datasets import DatasetCatalog, register_builtin
from ..data.loader import EvalLoader, SemiSupLoader
from ..evaluation import evaluate_detections
from ..events import ConsoleWriter, EventStorage, JSONWriter, TensorboardWriter
from ..modeling.detector import PTDetector
from ..parallel.mesh import Mesh, all_reduce_sum, make_mesh, replicate
from ..parallel.prefetch import DevicePrefetcher, host_to_device
from ..solver import auto_scale_config, build_optimizer
from ..structures import GroundTruth, ImageBatch, resolve_device
from .steps import create_train_state, make_train_steps

logger = logging.getLogger("probabilisticteacher_torch")


def trainer_device(name: str) -> torch.device:
    """``MODEL.DEVICE``: ``"cpu"`` is the CPU, any other value the card (which
    must be present)."""
    return resolve_device("cpu" if str(name).lower() == "cpu" else None)


def data_parallel_size(cfg, world: int) -> int:
    """The ranks that train out of ``world``: all of them, which must divide both
    per-stream batch sizes (the reference's check, ``pt/data/build.py:173-187``),
    or, under ``PARALLEL.ALLOW_DEVICE_SUBSET``, the largest count that does."""
    bl, bu = int(cfg.SOLVER.IMG_PER_BATCH_LABEL), int(cfg.SOLVER.IMG_PER_BATCH_UNLABEL)
    n_use = math.gcd(math.gcd(bl, bu), world)
    if n_use != world:
        msg = (f"IMG_PER_BATCH_{{LABEL,UNLABEL}}=({bl},{bu}) not divisible by the {world} "
               f"ranks; only {n_use} would be used. Set batch sizes to a multiple of "
               f"{world}, or set PARALLEL.ALLOW_DEVICE_SUBSET True to train on {n_use} ranks.")
        if not bool(cfg.PARALLEL.ALLOW_DEVICE_SUBSET):
            raise ValueError(msg)
        logger.warning(msg)
    return n_use


class StepMetrics:
    """One step's metrics on their way to the host.

    The values are stacked into one tensor and copied to pinned host memory behind
    the step's kernels, with an event recorded after the copy; :meth:`values`
    waits for that event only, so reading step i's metrics never waits for step
    i + 1, which may already be queued.
    """

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        self.names = list(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in self.names])
        self._stacked = stacked
        self._event: Optional[torch.cuda.Event] = None
        if stacked.is_cuda:
            self._host = stacked.to("cpu", non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = stacked

    def values(self, mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """The metrics; over several ranks, the sum of the ranks' shares (every rank
        must call this at the same iteration)."""
        if mesh is not None and mesh.distributed:
            return dict(zip(self.names, all_reduce_sum(mesh, self._stacked).tolist()))
        if self._event is not None:
            self._event.synchronize()
        return dict(zip(self.names, self._host.tolist()))


class PTrainer:
    def __init__(self, cfg):
        cfg = auto_scale_config(cfg.clone() if getattr(cfg, "__immutable__", False) else cfg)
        self.cfg = cfg
        world = data_parallel_size(cfg, int(os.environ.get("WORLD_SIZE", 1)))
        self.mesh = make_mesh(trainer_device(cfg.MODEL.DEVICE), world_size=world)
        self.device = self.mesh.device
        register_builtin()
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        if self.mesh.rank == 0:   # provenance dump, one writer
            with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
                f.write(cfg.dump())

        self.arch = Arch.from_cfg(cfg)
        seed = max(int(cfg.SEED), 0)
        student = PTDetector(self.arch, device=self.device)
        student.init(seed)
        pretrain = cfg.MODEL.VGG.PRETRAIN
        if pretrain and os.path.exists(pretrain):
            student.load_state_dict(load_vgg_caffe(student.state_dict(), pretrain))
            logger.info(f"Loaded Caffe VGG pretrained weights from {pretrain}")
        elif pretrain:
            logger.warning(f"Pretrained backbone {pretrain} not found; training from scratch")
        replicate(self.mesh, student)
        self.state = create_train_state(student, build_optimizer(cfg, student))
        self.burnin_step, self.mutual_step = make_train_steps(cfg, student, self.mesh)

        self.start_iter = 0
        self.max_iter = int(cfg.SOLVER.MAX_ITER)
        self.burn_up = int(cfg.UNSUPNET.BURN_UP_STEP)
        self.storage = EventStorage()
        # rank 0 writes: other ranks would interleave lines in metrics.json
        self.writers = [] if self.mesh.rank != 0 else [
            ConsoleWriter(self.max_iter),
            JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json")),
            TensorboardWriter(cfg.OUTPUT_DIR),
        ]
        self.write_period = 20
        self._seed = seed + 17
        self._gen = torch.Generator(device=self.device)

        # hook engine (reference build_hooks, pt/engine/trainer.py:498-547)
        self.iter = 0
        self.pending_metrics: Optional[StepMetrics] = None   # the previous step's
        self.last_data_time = 0.0
        self._hooks = []
        self.register_hooks(self.build_hooks())

    # ------------------------------------------------------------------ hooks
    def build_hooks(self):
        """Default hook set; override or extend via register_hooks."""
        from .hooks import (DivergenceGuardHook, EvalHook, IterationTimer, MemoryGuardHook,
                            PeriodicCheckpointer, PeriodicWriter, ProfilerHook,
                            TeacherHealthHook)

        hooks = [IterationTimer()]
        # health guards go early in registration so their after_step runs
        # AFTER PeriodicWriter/EvalHook (reverse order) and sees fresh values
        if bool(self.cfg.UNSUPNET.ABORT_ON_NONFINITE):
            hooks.append(DivergenceGuardHook())
        pseudo_drop = float(self.cfg.UNSUPNET.HEALTH_PSEUDO_DROP)
        map_drop = float(self.cfg.UNSUPNET.HEALTH_MAP_DROP)
        if pseudo_drop > 0 or map_drop > 0:
            hooks.append(TeacherHealthHook(int(self.cfg.TEST.EVAL_PERIOD),
                                           pseudo_drop, map_drop))
        prof = self.cfg.PROFILER
        if prof.ENABLED:
            hooks.append(ProfilerHook(prof.START_STEP, prof.NUM_STEPS,
                                      os.path.join(self.cfg.OUTPUT_DIR, "profile")))
        hooks.append(PeriodicCheckpointer(int(self.cfg.SOLVER.CHECKPOINT_PERIOD)))
        hooks.append(EvalHook(int(self.cfg.TEST.EVAL_PERIOD)))
        hooks.append(PeriodicWriter(self.write_period))
        if float(self.cfg.SOLVER.HOST_RSS_LIMIT_GB) > 0:
            hooks.append(MemoryGuardHook(float(self.cfg.SOLVER.HOST_RSS_LIMIT_GB)))
        return hooks

    def register_hooks(self, hooks):
        for h in hooks:
            h.trainer = self
            self._hooks.append(h)

    # ------------------------------------------------------------------ data
    def build_train_loader(self) -> SemiSupLoader:
        label_dicts, unlabel_dicts = [], []
        for name in self.cfg.DATASETS.TRAIN_LABEL:
            label_dicts.extend(DatasetCatalog.get(name))
        for name in self.cfg.DATASETS.TRAIN_UNLABEL:
            unlabel_dicts.extend(DatasetCatalog.get(name))
        # each rank loads its 1/W of the global batch with its own sample stream
        return SemiSupLoader(self.cfg, label_dicts, unlabel_dicts,
                             seed=max(int(self.cfg.SEED), 0) + 9973 * self.mesh.rank,
                             world_size=self.mesh.world_size)

    # --------------------------------------------------------------- restore
    def resume_or_load(self, resume: bool = False):
        if resume:
            path = latest_checkpoint(self.cfg.OUTPUT_DIR)
            if path:
                load_checkpoint(path, self.state)
                replicate(self.mesh, self.state)
                self.start_iter = int(self.state.step)
                logger.info(f"Resumed from {path} at iter {self.start_iter}")
                return
        weights = self.cfg.MODEL.WEIGHTS
        if weights and os.path.exists(weights):
            from ..d2_import import is_d2_checkpoint, load_detectron2_weights

            if is_d2_checkpoint(weights):
                # reference/detectron2-format torch checkpoint (the published PT
                # result weights load through here with --eval-only)
                load_detectron2_weights(weights, self.state,
                                        self.cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
            else:
                load_weights(weights, self.state)
            replicate(self.mesh, self.state)
            logger.info(f"Loaded weights from {weights}")

    # ------------------------------------------------------------------ train
    def _shard_for_iter(self, batch: Dict, it: int) -> Dict:
        """Host batch -> device tensors for iteration ``it``.

        The unlabeled images go to the device only for mutual-phase iterations
        (burn-in consumes labeled data only, ``pt/engine/trainer.py:274-288``);
        the host arrays are kept alongside so a phase mismatch can be healed by
        an on-demand copy (run_step).
        """
        dev = self.device
        lb = batch["label"]
        out = {"limg": ImageBatch(host_to_device(lb["image"], dev),
                                  host_to_device(lb["image_hw"], dev)),
               "lgt": GroundTruth(host_to_device(lb["gt_boxes"], dev),
                                  host_to_device(lb["gt_classes"].astype(np.int32), dev),
                                  host_to_device(lb["gt_valid"], dev)),
               "host_unlabel": batch["unlabel"]}
        if it >= self.burn_up:
            out["uimg"] = self._unlabel_images(batch["unlabel"])
        return out

    def _unlabel_images(self, hu: Dict) -> ImageBatch:
        return ImageBatch(host_to_device(hu["image"], self.device),
                          host_to_device(hu["image_hw"], self.device))

    def make_batch_iterator(self, loader_iter):
        """Wrap a host loader iterator in the device prefetcher: batch N+1 is copied
        on a side stream by a background thread while step N runs.

        ``DATALOADER.DEVICE_PREFETCH`` is the queue depth (device memory for that
        many extra batches); 0 disables the overlap (synchronous path).
        """
        depth = int(self.cfg.DATALOADER.DEVICE_PREFETCH)
        if depth <= 0:
            return loader_iter
        return DevicePrefetcher(loader_iter, self._shard_for_iter,
                                start_iter=self.start_iter, depth=depth, device=self.device)

    def step_generator(self, it: int) -> torch.Generator:
        """The device generator, reseeded for iteration ``it``."""
        return self._gen.manual_seed(self._seed * 1_000_003 + it)

    def run_step(self, batch_iter):
        """One training iteration: (prefetched) batch -> burn-in or mutual step.

        Accepts either a DevicePrefetcher (device batches, the ``train()`` path)
        or a raw host-batch iterator (tests/tools); host batches are copied here.
        The metrics start their way to the host (``pending_metrics``);
        PeriodicWriter reads them one step later.
        """
        t0 = time.perf_counter()
        batch = next(batch_iter)
        self.last_data_time = time.perf_counter() - t0

        if "limg" not in batch:  # host batch: synchronous path
            batch = self._shard_for_iter(batch, self.iter)
        limg, lgt = batch["limg"], batch["lgt"]
        gen = self.step_generator(self.iter)
        if self.iter < self.burn_up:
            self.state, metrics = self.burnin_step(self.state, limg, lgt, gen)
        else:
            uimg = batch.get("uimg")
            if uimg is None:
                # phase mismatch (e.g. burn_up changed between prefetch and
                # consumption): heal with an on-demand copy
                uimg = self._unlabel_images(batch["host_unlabel"])
            self.state, metrics = self.mutual_step(self.state, limg, lgt, uimg, gen)
        self.pending_metrics = StepMetrics(metrics)

    def train(self):
        batch_iter = self.make_batch_iterator(iter(self.build_train_loader()))
        for h in self._hooks:
            h.before_train()
        try:
            for it in range(self.start_iter, self.max_iter):
                self.iter = it
                self.storage.iter = it
                for h in self._hooks:
                    h.before_step()
                self.run_step(batch_iter)
                for h in reversed(self._hooks):
                    h.after_step()
        finally:
            if hasattr(batch_iter, "close"):
                batch_iter.close()
        for h in reversed(self._hooks):
            h.after_train()

        save_checkpoint(self.cfg.OUTPUT_DIR, self.state)
        # the final eval is rank 0's; it holds no collective, so the others go on
        results: Dict[str, float] = {}
        if self.mesh.rank == 0:
            results = self.test(self.state.teacher)
            self.verify_results(results)
        return results

    def verify_results(self, results: Dict[str, float]) -> bool:
        """detectron2 ``verify_results`` (exercised at ``trainer.py:150-151``):
        compare against cfg.TEST.EXPECTED_RESULTS entries (task, metric, value, tol)."""
        expected = self.cfg.TEST.EXPECTED_RESULTS
        ok = True
        for entry in expected:
            _task, metric, value, tol = entry
            actual = results.get(metric)
            if actual is None or abs(actual - value) > tol:
                logger.error(f"Result verification failed: {metric}={actual}, "
                             f"expected {value} +- {tol}")
                ok = False
        if expected and ok:
            logger.info("Result verification passed.")
        return ok

    # ------------------------------------------------------------------- eval
    def eval_and_log(self, suffix: str, model: PTDetector) -> Dict[str, float]:
        results = self.test(model)
        self.storage.put_scalars(**{k + suffix: v for k, v in results.items()})
        logger.info(f"eval{suffix}: {results}")
        return results

    def validation_loss(self, model: PTDetector, dataset_name: str, max_batches: int = 20,
                        rng_seed: int = 0) -> Dict[str, float]:
        """Mean supervised losses over a labeled val set (LossEvalHook equivalent,
        ``pt/engine/hooks.py:24-133``, defined but never registered in the
        reference; offered here as a utility). Like :meth:`test`, it runs on the
        calling rank alone: its counts are its own and it holds no collective."""
        dicts = [d for d in DatasetCatalog.get(dataset_name) if d.get("annotations")]
        loader = EvalLoader(self.cfg, dicts)
        dev = self.device
        gen = torch.Generator(device=dev)
        totals: Dict[str, float] = {}
        n = 0
        with torch.no_grad():
            for i, batch in enumerate(loader):
                if i >= max_batches:
                    break
                images = ImageBatch(host_to_device(batch["image"], dev),
                                    host_to_device(batch["image_hw"], dev))
                gt = GroundTruth(host_to_device(batch["gt_boxes"], dev),
                                 host_to_device(batch["gt_classes"].astype(np.int32), dev),
                                 host_to_device(batch["gt_valid"], dev))
                losses = model.supervised_losses(images, gt, gen.manual_seed(rng_seed + i))
                for k, v in losses.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n += 1
        return {f"val_{k}": v / max(n, 1) for k, v in totals.items() if k.startswith("loss")}

    def test(self, model: PTDetector, max_images: int = 0) -> Dict[str, float]:
        style = "voc" if self.cfg.TEST.EVALUATOR == "VOCeval" else "coco"
        out = {}
        for name in self.cfg.DATASETS.TEST:
            dicts = DatasetCatalog.get(name)
            class_names: List[str] = list(DatasetCatalog.class_names(name) or [
                str(i) for i in range(self.arch.num_classes)])
            loader = EvalLoader(self.cfg, dicts)
            t0 = time.perf_counter()
            res = evaluate_detections(model, loader, class_names, style=style,
                                      max_images=max_images,
                                      gt_dicts=None if max_images else dicts)
            n = min(max_images, len(loader)) if max_images else len(loader)
            logger.info(f"eval on {name}: {n} images in "
                        f"{time.perf_counter() - t0:.3f} s")
            if len(self.cfg.DATASETS.TEST) > 1:
                # like detectron2's multi-dataset results dict: prefix with the
                # dataset name so a second test set can't overwrite the first
                res = {f"{name}/{k}": v for k, v in res.items()}
            out.update(res)
        return out
