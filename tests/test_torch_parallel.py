"""Data parallel over ranks (``parallel/mesh.py``) on the CPU: two gloo processes
against JAX on one device over the global batch.

- ``make_mesh``, ``shard_batch``, ``replicate``, ``host_max``, ``all_reduce_sum``,
  ``broadcast_values`` and ``all_reduce_grads`` in a world of one (the identity,
  no process group) and in two gloo processes;
- the TINY trajectory of ``tests/test_torch_train_step.py`` (``burnin_step`` x2,
  then ``mutual_step`` x1 across ``BURN_UP_STEP``) with its global batch of 2 + 2
  images split over 2 ranks, 1 + 1 each, and JAX's draws for the global batch
  replayed and sliced per rank, against JAX ``make_train_steps`` on one device:
  metrics (each rank's shares summed) within rtol 1e-4, student and teacher within
  1e-4 of each tensor's scale plus 1e-6, the two replicas bit-identical;
- the same with counts that differ between the ranks: rank 1's labeled image has
  no ground truth and its unlabeled image no pseudo box (an image size of 1 px
  leaves it no proposal). Per-rank normalizers with averaged gradients, the plain
  DDP recipe, fail this case far beyond its limits (CHANGES.md, PR 8, gives the
  numbers); the port's global counts pass it;
- ``PTrainer.train()`` in two processes, 4 iterations (2 burn-in, 2 mutual) with
  the EvalHook and the PeriodicCheckpointer firing at iteration 2, as
  ``tests/test_multihost.py`` runs the JAX trainer: identical students and teachers
  on both ranks, only rank 0 evaluates and writes, and rank 1's loader batches
  byte-identical to those of JAX's loader for process 1 of 2 (``SEED + 9973``).

Every spawned process has its own ``communicate`` time limit and all are killed
when one fails, so a hung collective fails the test instead of the run.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.config import get_cfg as jget_cfg
from probabilisticteacher_tpu.data import native as jnative
from probabilisticteacher_tpu.data.datasets import DatasetCatalog as JCatalog
from probabilisticteacher_tpu.data.datasets import register_pascal_voc as jregister
from probabilisticteacher_tpu.data.loader import SemiSupLoader as JLoader
from probabilisticteacher_tpu.engine.steps import create_train_state as jcreate_train_state
from probabilisticteacher_tpu.engine.steps import make_train_steps as jmake_train_steps
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.solver import build_optimizer as jbuild_optimizer
from probabilisticteacher_tpu.structures import GroundTruth as JGroundTruth
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch.config import Arch, add_config, get_cfg
from probabilisticteacher_torch.parallel import mesh as M
from probabilisticteacher_torch.weights import params_from_jax
from synthetic_data import make_voc_dataset
from test_torch_train_step import TINY, H, W, _data
from torch_jax_draws import burnin_draws, mutual_draws
from torch_micro import micro_opts

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
STEP_OPTS = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "2", "SOLVER.STEPS", "(100,)",
             "UNSUPNET.BURN_UP_STEP", "2", "UNSUPNET.EMA_KEEP_RATE", "0.5"]
TIMEOUT = 240


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _start(mode, work):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, WORKER, mode, str(r), "2", port, str(work)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(2)]


def _finish(procs, mode, work):
    """Wait for both ranks (each with its own time limit); kill both if one fails."""
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out[-2000:]}\n{err[-6000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(work, f"{mode}_rank{r}.pt"), weights_only=False)
            for r in range(2)]


# ------------------------------------------------------------------ world of one
def test_mesh_in_a_world_of_one(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = M.make_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group, mesh.distributed) == (0, 1, None, False)
    assert not torch.distributed.is_initialized()
    batch = {"x": torch.arange(6.0)}
    assert M.shard_batch(mesh, batch) is batch
    lin = torch.nn.Linear(2, 2)
    w = lin.weight.detach().clone()
    assert M.replicate(mesh, lin) is lin and torch.equal(lin.weight, w)
    assert M.host_max(mesh, 2.5) == 2.5 and M.broadcast_values(mesh, [1, 2]) == [1.0, 2.0]
    x = torch.tensor([3.0])
    assert M.all_reduce_sum(mesh, x) is x
    M.all_reduce_grads(mesh, lin.parameters())
    assert lin.weight.grad is None
    with M.global_counts(mesh):
        assert M.global_sum(5) == 5 and M.global_sum(x) is x
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="outside"):               # a subset of one
        M.make_mesh("cpu", world_size=1)
    monkeypatch.setenv("RANK", "0")
    assert M.make_mesh("cpu", world_size=1).world_size == 1
    with pytest.raises(ValueError, match="do not split"):
        M.shard_batch(M.Mesh(0, 2, torch.device("cpu")), {"x": torch.arange(3)})


# ------------------------------------------------------------------ steps
def _cases():
    limg, lhw, uimg, uhw, boxes, cls = _data(4)
    valid = np.ones(cls.shape, bool)
    equal = (limg, lhw, uimg, uhw, boxes, cls, valid)
    # rank 1 holds image 1 of each stream: no ground truth, and an unlabeled image
    # of 1 x 1 px, which leaves no proposal and so no pseudo box
    uhw2 = uhw.copy()
    uhw2[1] = 1.0
    valid2 = valid.copy()
    valid2[1] = False
    return {"equal": equal, "unequal": (limg, lhw, uimg, uhw2, boxes, cls, valid2)}


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """JAX over the global batch, and the two ranks' outputs, for both cases."""
    work = tmp_path_factory.mktemp("dp_steps")
    jcfg = jget_cfg()
    jcfg.merge_from_list(STEP_OPTS)
    jdet = JDetector(JArch(**TINY))
    params = jax.tree.map(np.array, jdet.init(jax.random.key(0), (H, W)))
    # scaled scores so that the teacher's detections clear the score filter
    params["rpn_head"]["objectness"]["kernel"] *= 30
    params["predictor"]["cls_score"]["kernel"] *= 10
    params["predictor"]["cls_score"]["bias"][-1] = -6.0
    arch = Arch(**TINY)
    key = jax.random.key(11)
    n, g = 2, 3
    anchors = (H // 16) * (W // 16) * 3
    rows = TINY["rpn_post_nms_topk"][1] + g
    draws = [burnin_draws(key, 0, n, anchors, rows), burnin_draws(key, 1, n, anchors, rows),
             mutual_draws(key, 2, n, n, anchors, rows)]
    cases = _cases()
    torch.save({"arch": TINY, "cfg": STEP_OPTS, "cases": {
        name: {"params": params_from_jax(params, arch), "draws": draws,
               "batch": tuple(torch.from_numpy(x) for x in batch)}
        for name, batch in cases.items()}}, os.path.join(work, "steps_input.pt"))
    procs = _start("steps", work)

    tx = jbuild_optimizer(jcfg, params)
    jburnin, jmutual = jmake_train_steps(jcfg, jdet, tx)
    want = {}
    for name, (limg, lhw, uimg, uhw, boxes, cls, valid) in cases.items():
        jstate = jcreate_train_state(jdet, tx, params=jax.tree.map(jnp.asarray, params))
        jl, ju = JImageBatch(jnp.asarray(limg), jnp.asarray(lhw)), JImageBatch(
            jnp.asarray(uimg), jnp.asarray(uhw))
        jgt = JGroundTruth(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid))
        metrics = []
        for _ in range(2):
            jstate, jm = jburnin(jstate, jl, jgt, key)
            metrics.append(jm)
        jstate, jm = jmutual(jstate, jl, jgt, ju, key)
        metrics.append(jm)
        want[name] = (metrics, jstate)
    return want, _finish(procs, "steps", work), arch


def test_mesh_utilities_over_two_ranks(steps_run):
    _, ranks, _ = steps_run
    for r, out in enumerate(ranks):
        u = out["utils"]
        assert torch.equal(u["shard"]["x"], torch.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        assert torch.equal(u["shard"]["t"][0], torch.arange(4)[2 * r:2 * r + 2])
        assert u["host_max"] == 1.5
        assert torch.equal(u["sum"], torch.tensor([2.0, 1.0]))
        assert u["broadcast"] == [7.0, 3.0]
        assert torch.equal(u["replicated"], torch.zeros(2, 3))    # rank 0's weights


def _close_params(jparams, sd, arch, what):
    want = params_from_jax(jax.tree.map(np.asarray, jparams), arch)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(sd[name].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", ["equal", "unequal"])
def test_two_ranks_match_jax_on_the_global_batch(steps_run, case):
    want, ranks, arch = steps_run
    jmetrics, jstate = want[case]
    for step, jm in enumerate(jmetrics):
        got = ranks[0][case]["metrics"][step]
        assert got == ranks[1][case]["metrics"][step]
        assert set(got) == set(jm)
        for k in jm:
            np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    _close_params(jstate.student, ranks[0][case]["student"], arch, "student")
    _close_params(jstate.teacher, ranks[0][case]["teacher"], arch, "teacher")
    for part in ("student", "teacher"):                  # the replicas are bit-identical
        for k, v in ranks[0][case][part].items():
            assert torch.equal(v, ranks[1][case][part][k]), (part, k)
    mutual = jmetrics[-1]
    assert float(mutual["num_pseudo_boxes"]) > 0 and float(mutual["loss_box_reg_unsup"]) > 0
    if case == "unequal":
        # JAX's global value is rank 0's pseudo boxes over 2 images: rank 1 has none
        assert float(want["equal"][0][-1]["num_pseudo_boxes"]) > float(
            mutual["num_pseudo_boxes"])


# ------------------------------------------------------------------ trainer
def test_two_process_trainer(tmp_path):
    work = tmp_path
    voc = os.path.join(work, "voc")
    make_voc_dataset(os.path.join(voc, "src"), "train", num_images=4, seed=0)
    make_voc_dataset(os.path.join(voc, "tgt"), "train", num_images=4, seed=1)
    make_voc_dataset(os.path.join(voc, "val"), "val", num_images=2, seed=2)
    out_dir = os.path.join(work, "out")
    opts = micro_opts(out_dir, "dp_l", "dp_u", "dp_v") + [
        "TEST.EVAL_PERIOD", "2", "SOLVER.CHECKPOINT_PERIOD", "2"]
    cfg = get_cfg()
    add_config(cfg)
    cfg.merge_from_list(opts)
    with open(os.path.join(work, "trainer.yaml"), "w") as f:
        f.write(cfg.dump())
    procs = _start("trainer", work)

    # JAX's loader for process 1 of 2, meanwhile
    jcfg = jget_cfg()
    jcfg.merge_from_list(opts)
    classes = ("truck", "car", "rider", "person", "train", "motorcycle", "bicycle", "bus")
    for name, sub, split in (("dp_l", "src", "train"), ("dp_u", "tgt", "train")):
        if not JCatalog.has(name):
            jregister(name, os.path.join(voc, sub), split, classes)
    jnative.available()   # JAX's native library, loaded before its loader threads start
    jloader = iter(JLoader(jcfg, JCatalog.get("dp_l"), JCatalog.get("dp_u"),
                           seed=max(int(jcfg.SEED), 0) + 9973, world_size=2))
    jbatches = [next(jloader) for _ in range(4)]
    jloader.close()

    r0, r1 = _finish(procs, "trainer", work)
    assert r0["step"] == r1["step"] == 4
    assert r0["mesh"] == (0, 2) and r1["mesh"] == (1, 2)
    for part in ("student", "teacher"):
        for k, v in r0[part].items():
            assert torch.equal(v, r1[part][k]), (part, k)
    # rank 0 evaluated (at iteration 2 and at the end) and wrote; rank 1 did neither
    assert np.isfinite(r0["results"]["mAP50"]) and r0["evaluated"] and r0["writers"] == 3
    assert r1["results"] == {} and not r1["evaluated"] and r1["writers"] == 0
    for f in ("config.yaml", "metrics.json", "model_0000002", "model_0000004"):
        assert os.path.isfile(os.path.join(out_dir, f)), f
    with open(os.path.join(out_dir, "last_checkpoint")) as f:
        assert f.read() == "model_0000004"
    for jb, tb in zip(jbatches, r1["batches"]):
        for stream in ("label", "unlabel"):
            assert jb[stream].keys() == tb[stream].keys()
            for k, v in jb[stream].items():
                assert np.asarray(v).tobytes() == np.asarray(tb[stream][k]).tobytes(), (stream, k)
    assert len(r1["batches"]) == 4
