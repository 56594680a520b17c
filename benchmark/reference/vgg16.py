"""The VGG16 detector's reference under the names ``runner.REFERENCE_NAMES`` asks
for: the detector of ``model.py`` and the steps of ``step.py``. A configuration that
names no ``"reference"`` module runs this one."""

from .model import Arch, GroundTruth, ImageBatch, fp8_e4m3
from .model import PTDetector as Detector
from .model import _exact as exact
from .step import build_state, burnin_step, mutual_step

__all__ = ["Arch", "Detector", "ImageBatch", "GroundTruth", "exact", "fp8_e4m3",
           "build_state", "burnin_step", "mutual_step"]
