"""Probabilistic Teacher in PyTorch for NVIDIA Hopper: the port of
``probabilisticteacher_tpu``.

The JAX package stays the reference; this package imports neither JAX nor it.
Plain tensor code is PyTorch; the JAX package's Pallas kernels on the ported
path are CUDA C++ kernels under ``csrc/``, built with ``nvcc`` at first use. Entry
points run on the card unless the caller passes ``device="cpu"``, where every
kernel's plain PyTorch version runs instead.
"""

from .config import Arch, CfgNode, get_cfg
from .structures import Detections, GroundTruth, ImageBatch, Proposals, PseudoLabels

__all__ = ["Arch", "CfgNode", "get_cfg", "Detections", "GroundTruth", "ImageBatch",
           "Proposals", "PseudoLabels"]
