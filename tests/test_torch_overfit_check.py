"""The port's ``overfit_check`` (``probabilisticteacher_torch/diagnostics/``) against the
JAX package's ``scripts/overfit_check.py``.

- the config the port's trainer gets equals the one the JAX script hands its
  ``PTrainer`` (captured by a stand-in trainer), key by key, with and without the
  script's flags; only ``MODEL.DEVICE`` differs (the card by default, ``cpu`` here);
- 6 iterations on the CPU (3 burn-in, 3 mutual) end with finite mAP50 readings of
  the student before, and of the student and the teacher after, training;
- the bar passes and misses as the JAX script's does, a miss exiting non-zero.
"""

import os
import sys

import numpy as np
import pytest
import yaml

from probabilisticteacher_torch.diagnostics import overfit_check as oc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = v
    return out


def _plain(cfg):
    return _flat(yaml.safe_load(cfg.dump()))


@pytest.mark.parametrize("flags", [[], ["--amp", "--danchor", "--nms", "maxpool"]])
def test_overfit_config_matches_the_jax_script(flags, monkeypatch, tmp_path):
    sys.path.insert(0, SCRIPTS)
    import overfit_check as jax_overfit

    from probabilisticteacher_tpu.engine import trainer as jax_trainer

    seen = []

    class Handed(Exception):
        pass

    def capture(cfg):
        seen.append(cfg)
        raise Handed

    monkeypatch.setattr(jax_trainer, "PTrainer", capture)
    monkeypatch.setattr(jax_overfit.tempfile, "mkdtemp", lambda prefix="": str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["overfit_check.py", *flags])
    with pytest.raises(Handed):
        jax_overfit.main()
    theirs = _plain(seen[0])
    mine = _plain(oc.overfit_cfg(oc.build_parser().parse_args(flags + ["--device", "cpu"]),
                                 str(tmp_path / "jax")))
    assert set(mine) == set(theirs)
    assert {k: (mine[k], theirs[k]) for k in mine
            if mine[k] != theirs[k] and k != "MODEL.DEVICE"} == {}
    assert mine["MODEL.DEVICE"] == "cpu"
    assert oc.build_parser().parse_args([]).device == "cuda"


def test_overfit_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = oc.run(oc.build_parser().parse_args(["--device", "cpu", "--iters", "6",
                                               "--burnup", "3"]))
    assert set(res) == {"before", "student", "teacher", "bar"}
    assert all(np.isfinite(v) for v in res.values())
    assert res["bar"] == max(res["before"] + 10, 20)
    out = capsys.readouterr().out
    assert "mAP50 before training:" in out and "mAP50 after 6 iters: student=" in out


def test_overfit_bar_is_enforced(capsys):
    oc.check_bar({"before": 0.0, "student": 20.5, "teacher": 30.0, "bar": 20})
    assert "OVERFIT CHECK PASSED" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="model failed to overfit: 0.00 -> 19.00 \\(bar 20\\)"):
        oc.check_bar({"before": 0.0, "student": 19.0, "teacher": 30.0, "bar": 20})
