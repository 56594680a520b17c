"""The PyTorch port stands alone and never moves to the CPU on its own.

- every module of ``probabilisticteacher_torch`` and every import of
  ``chip_smoke.py`` loads without JAX, flax or the JAX package (checked in a fresh
  interpreter, since this test process has JAX loaded);
- entry points default to the card and raise when there is none, unless the
  caller asks for the CPU;
- approximate RPN NMS modes that are not ported raise instead of running the
  exact NMS under their name.
"""

import os
import subprocess
import sys

import pytest
import torch

from probabilisticteacher_torch import config as tcfg
from probabilisticteacher_torch.modeling.detector import PTDetector
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "probabilisticteacher_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHECK.format(repo=REPO)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15   # every module of the slice was imported


def test_card_is_the_default_and_its_absence_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(tcfg.get_cfg())
    assert resolve_device("cpu") == torch.device("cpu")
    assert PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("impl", ["maxpool", "maxpool_train", "hybrid"])
def test_unported_nms_modes_raise(impl):
    with pytest.raises(NotImplementedError, match="A13"):
        PTDetector(tcfg.Arch(vgg_depth=11, fc_dim=8, rpn_nms_impl=impl), device="cpu")


def test_seeded_init_is_deterministic():
    arch = tcfg.Arch(vgg_depth=11, fc_dim=8, num_classes=2, learnable_anchors=True)
    a = PTDetector(arch, device="cpu").init(3)
    b = PTDetector(arch, device="cpu").init(3)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(PTDetector(arch, device="cpu").init(4)["rpn_head.conv.weight"],
                           a["rpn_head.conv.weight"])
