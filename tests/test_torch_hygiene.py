"""The PyTorch port stands alone and never moves to the CPU on its own.

- every module of ``probabilisticteacher_torch`` (the bench entry, its roofline and
  lever sweep included) and every import of ``chip_smoke.py`` loads without JAX,
  flax, the JAX package, the root ``bench.py`` or ``scripts/`` (checked in a fresh
  interpreter, since this test process has JAX loaded);
- entry points (detector, Predictor, trainer, CLI, ``make_mesh``) default to the
  card and raise when there is none, unless the caller asks for the CPU;
- an RPN NMS mode the port does not know raises instead of running the exact NMS
  under its name (the levers themselves are held to JAX in
  ``tests/test_torch_levers.py``).
"""

import os
import subprocess
import sys

import pytest
import torch

from probabilisticteacher_torch import config as tcfg
from probabilisticteacher_torch import train_net
from probabilisticteacher_torch.engine.trainer import PTrainer, trainer_device
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.parallel.mesh import make_mesh
from probabilisticteacher_torch.predictor import Predictor
from probabilisticteacher_torch.structures import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import probabilisticteacher_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its imports only: the run is under __main__
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "probabilisticteacher_tpu", "bench",
                                    "scripts", "roofline", "lever_sweep"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK.format(repo=REPO)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # every module of the slices was imported, the mesh and the levers' modules too, and
    # the bench entry's three (bench, roofline, lever_sweep)
    assert int(out.stdout.split()[-1]) >= 47


def test_card_is_the_default_and_its_absence_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(tcfg.get_cfg())
    # the trainer and the CLI: MODEL.DEVICE keeps the config's default "tpu", which
    # the port reads as the card; only "cpu" is the CPU
    cfg = tcfg.get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    assert cfg.MODEL.DEVICE == "tpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTrainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net.main(train_net.parse_args(["OUTPUT_DIR", str(tmp_path / "cli")]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert make_mesh("cpu").device == torch.device("cpu")
    assert trainer_device("cpu") == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8), device="cpu").device.type == "cpu"


def test_unknown_nms_mode_raises():
    with pytest.raises(ValueError, match="NMS_IMPL 'maxpol'"):
        PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8, rpn_nms_impl="maxpol"), device="cpu")


def test_seeded_init_is_deterministic():
    arch = tcfg.Arch(vgg_depth=11, fc_dim=8, num_classes=2, learnable_anchors=True)
    a = PTDetector(arch, device="cpu").init(3)
    b = PTDetector(arch, device="cpu").init(3)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(PTDetector(arch, device="cpu").init(4)["rpn_head.conv.weight"],
                           a["rpn_head.conv.weight"])
