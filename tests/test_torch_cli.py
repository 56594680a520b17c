"""The port's CLI on the CPU: ``python -m probabilisticteacher_torch.train_net``.

With ``MODEL.DEVICE cpu``, the recipe YAML ``configs/pt/final_c2f.yaml`` and the
micro overrides of ``tests/torch_micro.py``: train (2 burn-in + 2 mutual steps,
checkpoints at 2 and 4, the dual eval at 4), ``--resume`` to 6 (starting at 4),
``--eval-only`` of ``model_0000004`` equal to the trainer's eval of the same
weights (the student, as the root ``train_net.py`` evaluates it), and
``NotImplementedError`` naming ROADMAP A12 for data parallel.
"""

import json
import os

import numpy as np
import pytest

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


@pytest.mark.parametrize("argv,env", [(["--num-gpus", "2"], {}),
                                      (["--num-machines", "2"], {}),
                                      ([], {"COORDINATOR_ADDRESS": "localhost:1234"})])
def test_cli_data_parallel_is_not_ported(tmp_path, names, monkeypatch, argv, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="A12"):
        _cli(argv + ["--config-file", RECIPE] + micro_opts(tmp_path, *names))
    assert not os.path.exists(tmp_path / "config.yaml")   # raised before any side effect
