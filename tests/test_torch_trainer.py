"""The port's trainer shell on the CPU: PTrainer, hooks and the CLI.

- the batches that the port's and JAX's ``PTrainer`` hand to their step functions
  over 4 iterations (loader -> prefetcher -> device copy), with the steps replaced
  by recorders: identical arrays and the same burn-in/mutual decisions;
- the hook engine and hooks of ``tests/test_hooks.py``: call order, defaults, the
  ``lr`` written, BestCheckpointer, DivergenceGuard, TeacherHealth, MemoryGuard
  (exit 75) and the ``--supervise`` relaunch;
- the trainer cases of ``tests/test_e2e.py``: validation loss, dataset-prefixed
  metrics for several test sets, an unlabeled stream without annotations.

The CLI is driven by ``tests/test_torch_cli.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.config import get_cfg as jget_cfg
from probabilisticteacher_tpu.data import native as jnative
from probabilisticteacher_tpu.data.datasets import register_pascal_voc as jregister
from probabilisticteacher_tpu.engine.trainer import PTrainer as JTrainer
from probabilisticteacher_torch import train_net
from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.data.datasets import DatasetCatalog, register_pascal_voc
from probabilisticteacher_torch.data.loader import SemiSupLoader
from probabilisticteacher_torch.engine import hooks as H
from probabilisticteacher_torch.engine.steps import create_train_state
from probabilisticteacher_torch.engine.trainer import PTrainer, StepMetrics
from probabilisticteacher_torch.events import EventStorage
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.parallel.mesh import Mesh
from probabilisticteacher_torch.solver import build_lr_schedule, build_optimizer
from synthetic_data import CLASSES
from torch_micro import micro_opts, register_both, voc_tree

@pytest.fixture(scope="module")
def names(tmp_path_factory):
    root = voc_tree(str(tmp_path_factory.mktemp("voc")))
    return register_both(jregister, register_pascal_voc, "ttr", root, CLASSES)


def _cfg(out, names, **kw):
    cfg = get_cfg()
    cfg.merge_from_list(micro_opts(out, *names, **kw))
    return cfg


# ------------------------------------------------------- batches vs the JAX trainer
def _record(trainer, steps, n=4):
    """Run ``n`` iterations through the trainer's own loader, prefetcher and copy,
    with ``steps`` (burnin, mutual) replacing the step functions."""
    trainer.burnin_step, trainer.mutual_step = steps
    batch_iter = trainer.make_batch_iterator(iter(trainer.build_train_loader()))
    try:
        for it in range(n):
            trainer.iter = it
            trainer.run_step(batch_iter)
    finally:
        batch_iter.close()


def _arrays(phase, limg, lgt, uimg=None):
    out = {"phase": phase}
    for key, x in (("image", limg.image), ("image_hw", limg.image_hw), ("boxes", lgt.boxes),
                   ("classes", lgt.classes), ("valid", lgt.valid)):
        out[key] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if uimg is not None:
        for key, x in (("u_image", uimg.image), ("u_image_hw", uimg.image_hw)):
            out[key] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def test_step_inputs_match_the_jax_trainer(tmp_path, names):
    jcfg = jget_cfg()
    jcfg.merge_from_list(micro_opts(tmp_path / "j", *names) + [
        "PARALLEL.ALLOW_DEVICE_SUBSET", "True", "COMPILE_CACHE_DIR", ""])
    jrec, trec = [], []

    def jburn(state, limg, lgt, rng):
        jrec.append(_arrays("burnin", limg, lgt))
        return state._replace(step=state.step + 1), {"total_loss": jnp.float32(0)}

    def jmut(state, limg, lgt, uimg, rng):
        jrec.append(_arrays("mutual", limg, lgt, uimg))
        return state._replace(step=state.step + 1), {"total_loss": jnp.float32(0)}

    def tburn(state, limg, lgt, gen):
        trec.append(_arrays("burnin", limg, lgt))
        state.step += 1
        return state, {"total_loss": torch.zeros(())}

    def tmut(state, limg, lgt, uimg, gen):
        trec.append(_arrays("mutual", limg, lgt, uimg))
        state.step += 1
        return state, {"total_loss": torch.zeros(())}

    # load JAX's native library before its loader threads start: its first use is
    # not locked, and a second thread that arrives during the load decodes with PIL
    jnative.available()
    _record(JTrainer(jcfg), (jburn, jmut))
    _record(PTrainer(_cfg(tmp_path / "t", names)), (tburn, tmut))
    assert [r["phase"] for r in trec] == [r["phase"] for r in jrec] == ["burnin"] * 2 + [
        "mutual"] * 2
    for j, t in zip(jrec, trec):
        assert j.keys() == t.keys()
        for k in j:
            if k != "phase":
                assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes(), k


def test_step_generator_is_reseeded_per_iteration(tmp_path, names):
    tr = PTrainer(_cfg(tmp_path, names))
    a = torch.rand(4, generator=tr.step_generator(3))
    torch.rand(4, generator=tr.step_generator(4))
    assert torch.equal(torch.rand(4, generator=tr.step_generator(3)), a)


def test_step_metrics_names_and_total(tmp_path, names):
    """Mutual metrics carry the *_sup/*_unsup names; total_loss sums only loss_*."""
    cfg = _cfg(tmp_path, names, burn_up=0)
    det = PTDetector(Arch.from_cfg(cfg), device="cpu")
    det.init(0)
    state = create_train_state(det, build_optimizer(cfg, det))
    tr = PTrainer(cfg)
    batch = next(iter(tr.build_train_loader()))
    dev = tr._shard_for_iter(batch, 0)
    _, m = tr.mutual_step(state, dev["limg"], dev["lgt"], dev["uimg"], tr.step_generator(0))
    vals = StepMetrics(m).values()
    assert {"loss_rpn_cls_sup", "loss_box_reg_sup", "loss_cls_unsup", "loss_box_reg_unsup",
            "total_loss", "num_pseudo_boxes", "rpn/num_pos_anchors_sup"} <= set(vals)
    total = sum(v for k, v in vals.items() if k.startswith("loss"))
    assert vals["total_loss"] == pytest.approx(total, rel=1e-5)


# ------------------------------------------------------------------------ hooks
class _Recorder(H.HookBase):
    def __init__(self, log, tag):
        self.log = log
        self.tag = tag

    def before_train(self):
        self.log.append((self.tag, "before_train"))

    def after_train(self):
        self.log.append((self.tag, "after_train"))

    def before_step(self):
        self.log.append((self.tag, "before_step", self.trainer.iter))

    def after_step(self):
        self.log.append((self.tag, "after_step", self.trainer.iter))


def test_custom_hooks_called_in_order(tmp_path, names):
    cfg = _cfg(tmp_path, names, max_iter=2, burn_up=1)
    cfg.TEST.EVAL_PERIOD = 0
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    trainer = PTrainer(cfg)
    kinds = [type(h).__name__ for h in trainer._hooks]
    assert {"IterationTimer", "PeriodicWriter", "PeriodicCheckpointer", "EvalHook"} <= set(kinds)
    log = []
    trainer.register_hooks([_Recorder(log, "a"), _Recorder(log, "b")])
    results = trainer.train()
    assert np.isfinite(results["mAP50"])
    assert ("a", "before_train") in log and ("b", "after_train") in log
    assert [e[2] for e in log if e[:2] == ("a", "before_step")] == [0, 1]
    assert log.index(("b", "after_step", 0)) < log.index(("a", "after_step", 0))
    assert "it/s" in trainer.storage.latest()
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    lr_recs = [r for r in recs if "lr" in r]
    assert lr_recs and "data_time" in lr_recs[-1]
    r = lr_recs[-1]
    assert r["lr"] == pytest.approx(build_lr_schedule(cfg)(r["iteration"]), rel=1e-6)


def test_health_hooks_registered_by_default(tmp_path, names):
    kinds = [type(h).__name__ for h in PTrainer(_cfg(tmp_path / "a", names))._hooks]
    assert kinds.index("DivergenceGuardHook") < kinds.index("PeriodicWriter")
    assert kinds.index("TeacherHealthHook") < kinds.index("EvalHook")
    cfg = _cfg(tmp_path / "b", names)
    cfg.UNSUPNET.ABORT_ON_NONFINITE = False
    cfg.UNSUPNET.HEALTH_PSEUDO_DROP = 0.0
    cfg.UNSUPNET.HEALTH_MAP_DROP = 0.0
    cfg.SOLVER.HOST_RSS_LIMIT_GB = 100.0
    cfg.PROFILER.ENABLED = True
    kinds = [type(h).__name__ for h in PTrainer(cfg)._hooks]
    assert "DivergenceGuardHook" not in kinds and "TeacherHealthHook" not in kinds
    assert "MemoryGuardHook" in kinds and "ProfilerHook" in kinds


def _mini_trainer(tmp_path, step=0):
    """A trainer stand-in for host-side hook logic, with a real tiny TrainState."""
    det = PTDetector(Arch(vgg_depth=11, fc_dim=8, num_classes=2), device="cpu")
    det.init(0)

    class Cfg:
        OUTPUT_DIR = str(tmp_path / "run")

    class T:
        cfg = Cfg()
        storage = EventStorage()
        iter = 0
        writers = []
        device = torch.device("cpu")
        mesh = Mesh(0, 1, device)
        state = create_train_state(det, build_optimizer(get_cfg(), det))

    os.makedirs(Cfg.OUTPUT_DIR, exist_ok=True)
    T.state.step = step
    return T()


def test_best_checkpointer(tmp_path):
    t = _mini_trainer(tmp_path)
    h = H.BestCheckpointer(eval_period=10, metric="mAP50")
    h.trainer = t
    best = os.path.join(t.cfg.OUTPUT_DIR, "model_best")
    t.iter = 10
    h.before_step()
    assert not os.path.exists(best)
    t.storage.put_scalars(mAP50=30.0)
    h.before_step()
    assert os.path.exists(best) and h.best == 30.0
    t.storage.put_scalars(mAP50=20.0)
    t.iter = 20
    h.before_step()
    assert h.best == 30.0
    t.storage.put_scalars(mAP50=44.0)
    h.after_train()
    assert h.best == 44.0
    assert not os.path.exists(os.path.join(t.cfg.OUTPUT_DIR, "last_checkpoint"))
    h2 = H.BestCheckpointer(eval_period=10)          # the best value survives a restart
    h2.trainer = t
    h2.before_train()
    assert h2.best == 44.0


def test_divergence_guard(tmp_path):
    t = _mini_trainer(tmp_path)
    h = H.DivergenceGuardHook()
    h.trainer = t
    h.after_step()
    t.storage.iter = 20
    t.storage.put_scalars(total_loss=1.5)
    h.after_step()
    for t.iter in (21, 22):                          # no new write, no new check
        h.after_step()
    assert h._checked_iter == 20
    t.storage.iter = 40
    t.storage.put_scalars(total_loss=float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 40"):
        h.after_step()
    t.storage.iter = 60
    t.storage.put_scalars(total_loss=float("inf"))
    with pytest.raises(FloatingPointError):
        h.after_step()


def test_teacher_health_pseudo_cliff_and_map_drop(tmp_path):
    t = _mini_trainer(tmp_path)
    h = H.TeacherHealthHook(eval_period=0, pseudo_drop=0.5, map_drop=0.0, min_history=5)
    h.trainer = t
    for i, v in enumerate([20.0, 22.0, 21.0, 19.0, 20.0, 21.0]):
        t.storage.iter = 20 * (i + 1)
        t.storage.put_scalars(num_pseudo_boxes=v)
        h.after_step()
    assert "health/collapse_flag" not in t.storage.latest()
    t.storage.iter = 200
    t.storage.put_scalars(num_pseudo_boxes=4.0)
    h.after_step()
    health = os.path.join(t.cfg.OUTPUT_DIR, "model_health")
    assert t.storage.latest()["health/collapse_flag"] == 1.0 and os.path.isfile(health)
    mt0 = os.path.getmtime(health)
    t.storage.iter = 220
    t.storage.put_scalars(num_pseudo_boxes=3.0)
    h.after_step()
    assert os.path.getmtime(health) == mt0

    t2 = _mini_trainer(tmp_path / "m")
    h2 = H.TeacherHealthHook(eval_period=10, pseudo_drop=0.0, map_drop=15.0)
    h2.trainer = t2
    for it, val in ((9, 64.8), (19, 60.0)):
        t2.storage.iter = t2.iter = it
        t2.storage.put_scalars(mAP50=val)
        h2.after_step()
    assert "health/collapse_flag" not in t2.storage.latest()
    t2.storage.iter = t2.iter = 29
    t2.storage.put_scalars(mAP50=28.5)
    h2.after_step()
    assert t2.storage.latest()["health/collapse_flag"] == 1.0


def test_memory_guard_hook(tmp_path):
    t = _mini_trainer(tmp_path, step=7)
    assert H.MemoryGuardHook.rss_kb() > 0
    h = H.MemoryGuardHook(limit_gb=10_000.0, period=1)
    h.trainer = t
    h.after_step()
    h = H.MemoryGuardHook(limit_gb=0.0001, period=1)
    h.trainer = t
    with pytest.raises(SystemExit) as e:
        h.after_step()
    assert e.value.code == 75
    assert os.path.isfile(os.path.join(t.cfg.OUTPUT_DIR, "model_0000007"))
    assert os.path.exists(os.path.join(t.cfg.OUTPUT_DIR, "last_checkpoint"))


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    t = _mini_trainer(tmp_path)
    out = os.path.join(t.cfg.OUTPUT_DIR, "profile")
    h = H.ProfilerHook(start_step=1, num_steps=2, output_dir=out)
    h.trainer = t
    for t.iter in range(4):
        h.before_step()
        torch.ones(8).sum()
        h.after_step()
    with open(os.path.join(out, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_supervise_restarts_on_75(monkeypatch):
    calls = []
    rcs = iter([75, 75, 0])

    def fake_call(cmd):
        calls.append(cmd)
        return next(rcs)

    monkeypatch.setattr("subprocess.call", fake_call)
    assert train_net.supervise(["--supervise", "--config-file", "x.yaml", "K", "V"]) == 0
    assert len(calls) == 3
    assert calls[0][1:3] == ["-m", "probabilisticteacher_torch.train_net"]
    assert "--supervise" not in calls[0] and "--resume" not in calls[0]
    for c in calls[1:]:
        assert c.count("--resume") == 1 and c.index("--resume") < c.index("K")


# ---------------------------------------------------------------- trainer cases
def test_validation_loss_and_multi_dataset_eval(tmp_path, names):
    cfg = _cfg(tmp_path, names)
    cfg.DATASETS.TEST = (names[2], names[0])
    tr = PTrainer(cfg)
    vl = tr.validation_loss(tr.state.student, names[2], max_batches=2)
    assert set(vl) == {"val_loss_rpn_cls", "val_loss_rpn_loc", "val_loss_cls", "val_loss_box_reg"}
    assert all(np.isfinite(v) for v in vl.values())
    res = tr.test(tr.state.student)
    assert f"{names[2]}/mAP50" in res and f"{names[0]}/mAP50" in res


def test_unlabeled_stream_without_annotations(tmp_path, names):
    cfg = _cfg(tmp_path, names)
    label = DatasetCatalog.get(names[0])
    unlabel = [dict(d, annotations=[]) for d in DatasetCatalog.get(names[1])]
    it = iter(SemiSupLoader(cfg, label, unlabel, seed=0))
    batch = next(it)
    it.close()
    assert not batch["unlabel"]["gt_valid"].any() and batch["label"]["gt_valid"].any()
