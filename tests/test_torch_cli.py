"""The port's CLI on the CPU: ``python -m probabilisticteacher_torch.train_net``.

With ``MODEL.DEVICE cpu``, the recipe YAML ``configs/pt/final_c2f.yaml`` and the
micro overrides of ``tests/torch_micro.py``: train (2 burn-in + 2 mutual steps,
checkpoints at 2 and 4, the dual eval at 4), ``--resume`` to 6 (starting at 4),
``--eval-only`` of ``model_0000004`` equal to the trainer's eval of the same
weights (the student, as the root ``train_net.py`` evaluates it); then data
parallel through the CLI: ``--num-gpus 2`` starts two gloo ranks on the CPU that
train to the end, rank 0 writing; more ranks than cards, batch sizes the ranks do
not divide, and ``--dist-url auto`` over several machines raise before anything is
written; ``PARALLEL.ALLOW_DEVICE_SUBSET`` trains on the ranks that divide the
batch sizes, and the others sit the run out.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.data.datasets import register_pascal_voc as jregister
from probabilisticteacher_torch import train_net
from probabilisticteacher_torch.data.datasets import register_pascal_voc
from probabilisticteacher_torch.engine.trainer import PTrainer
from synthetic_data import CLASSES
from torch_micro import micro_opts, register_both, voc_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "pt", "final_c2f.yaml")


@pytest.fixture(scope="module")
def names(tmp_path_factory):
    root = voc_tree(str(tmp_path_factory.mktemp("voc")))
    return register_both(jregister, register_pascal_voc, "tcli", root, CLASSES)


def _cli(argv):
    return train_net.main(train_net.parse_args(argv))


def test_cli_train_resume_and_eval_only(tmp_path, names, monkeypatch):
    trainers = []
    orig = PTrainer.resume_or_load

    def spy(self, resume=False):
        orig(self, resume)
        trainers.append(self)

    monkeypatch.setattr(PTrainer, "resume_or_load", spy)
    out = str(tmp_path / "out")
    base = ["--config-file", RECIPE] + micro_opts(out, *names)
    res = _cli(base)
    assert np.isfinite(res["mAP50"]) and np.isfinite(res["bbox/AP50"])
    for f in ("model_0000002", "model_0000004", "last_checkpoint", "metrics.json",
              "config.yaml", "log.txt"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read() == "model_0000004"
    with open(os.path.join(out, "metrics.json")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in recs] == [0, 3]
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    assert "loss_box_reg_unsup" in recs[-1] and "lr" in recs[-1]
    hook = trainers[0].storage.latest()        # the EvalHook's dual eval at 4
    assert all(hook[k] == v for k, v in res.items())   # teacher: the final eval's weights

    res2 = _cli(["--resume"] + base + ["SOLVER.MAX_ITER", "6"])
    assert trainers[1].start_iter == 4 and trainers[1].state.step == 6
    assert np.isfinite(res2["mAP50"])
    assert os.path.isfile(os.path.join(out, "model_0000006"))

    # --eval-only evaluates the student, as the root train_net.py does: the same
    # weights as the EvalHook's student eval at iteration 4
    res3 = _cli(["--config-file", RECIPE, "--eval-only"]
                + micro_opts(tmp_path / "eval", *names)
                + ["MODEL.WEIGHTS", os.path.join(out, "model_0000004")])
    student4 = {k[:-len("_student")]: v for k, v in hook.items() if k.endswith("_student")}
    assert res3.keys() == student4.keys()
    for k, v in res3.items():
        assert abs(v - student4[k]) <= 1e-6, k


BUILTIN = ("VOC2007_citytrain", "VOC2007_foggytrain", "VOC2007_foggyval")


def test_cli_trains_two_cpu_ranks(tmp_path):
    """``--num-gpus 2 MODEL.DEVICE cpu`` in a process of its own: the spawned ranks
    find the data through ``DETECTRON2_DATASETS`` and the builtin split names.
    Their TensorBoard writer is kept out (a ``sitecustomize`` blocks the import,
    which pulls in TensorFlow where it is installed: ~17 s); the JSON and console
    writers stay."""
    voc = voc_tree(str(tmp_path / "voc"))
    root = str(tmp_path / "ds")
    os.makedirs(os.path.join(root, "data"))
    for name, sub in zip(BUILTIN, ("src", "tgt", "val")):
        os.symlink(os.path.join(voc, sub), os.path.join(root, "data", name))
    hook = tmp_path / "site"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    out = tmp_path / "out"
    env = dict(os.environ, DETECTRON2_DATASETS=root, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(hook), REPO]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "probabilisticteacher_torch.train_net", "--num-gpus", "2",
         "--config-file", RECIPE] + micro_opts(out, *BUILTIN),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)      # the launcher and its ranks
            proc.communicate()
    assert proc.returncode == 0, f"{stdout[-3000:]}\n{stderr[-6000:]}"
    for f in ("model_0000002", "model_0000004", "metrics.json", "config.yaml", "log.txt",
              "log.txt.rank1"):
        assert os.path.isfile(os.path.join(out, f)), f
    with open(os.path.join(out, "metrics.json")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert [r["iteration"] for r in recs] == [0, 3]           # one writer: rank 0
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    assert "eval: {" in log and "mAP50" in log                # rank 0's final eval
    with open(os.path.join(out, "log.txt.rank1")) as f:
        assert "eval" not in f.read()


@pytest.mark.parametrize("argv,opts,env,error", [
    (["--num-gpus", "2"], [], {}, SystemExit),                         # one card
    (["--num-gpus", "2"], ["SOLVER.IMG_PER_BATCH_LABEL", "3"], {}, ValueError),
    (["--num-gpus", "2", "--num-machines", "2"], [], {}, ValueError),  # --dist-url auto
], ids=["more-ranks-than-cards", "indivisible-batch", "auto-url-over-machines"])
def test_cli_launch_raises_before_any_side_effect(tmp_path, names, monkeypatch, argv, opts,
                                                  env, error):
    for k in ("WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    device = "cuda" if error is SystemExit else "cpu"
    with pytest.raises(error):
        _cli(argv + ["--config-file", RECIPE]
             + micro_opts(tmp_path / "out", *names, device=device) + opts)
    assert not os.path.exists(tmp_path / "out")


def test_cli_device_subset(tmp_path, names, monkeypatch):
    """Rank 0 and rank 2 of a 3-rank launch with 2 + 2 images: without
    ``ALLOW_DEVICE_SUBSET`` it raises; with it, rank 0 trains alone (a world of one)
    and rank 2 returns at once, writing nothing."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    base = ["--config-file", RECIPE] + micro_opts(tmp_path / "out", *names, max_iter=2)
    with pytest.raises(ValueError, match="ALLOW_DEVICE_SUBSET"):
        _cli(base)
    subset = base + ["PARALLEL.ALLOW_DEVICE_SUBSET", "True", "TEST.EVAL_PERIOD", "0"]
    assert _cli(subset) == {} and not os.path.exists(tmp_path / "out")
    monkeypatch.setenv("RANK", "0")
    res = _cli(subset)
    assert np.isfinite(res["mAP50"])
    assert os.path.isfile(tmp_path / "out" / "model_0000002")
