"""Carry a JAX parameter tree over to :class:`PTDetector`'s ``state_dict``.

The JAX tree comes as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side), so this module needs
neither JAX nor the JAX package:

- convolution kernels HWIO -> OIHW;
- dense kernels (in, out) -> (out, in), including ``fc1``'s (P*P*C, F): its rows
  are already in the HWC order in which the port flattens the pooled block;
- biases and the learnable ``anchor_wh`` table as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import Arch
from .modeling.backbone import VGG_STAGES


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _conv(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            "bias": _t(p["bias"])}


def _dense(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def params_from_jax(params_np: Mapping[str, Any], arch: Arch) -> Dict[str, torch.Tensor]:
    """JAX param tree {"backbone", "rpn_head", "box_head", "predictor"[, "anchor_wh"]}
    -> a ``state_dict`` for ``PTDetector(arch)``."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
        for k, v in tensors.items():
            out[f"{prefix}.{k}"] = v

    for bi, channels in enumerate(VGG_STAGES[arch.vgg_depth], start=1):
        for ci in range(1, len(channels) + 1):
            name = f"block{bi}_conv{ci}"
            put(f"backbone.{name}", _conv(params_np["backbone"][name]))
    for name in ("conv", "objectness", "deltas"):
        put(f"rpn_head.{name}", _conv(params_np["rpn_head"][name]))
    for i in range(1, arch.num_fc + 1):
        put(f"box_head.fc{i}", _dense(params_np["box_head"][f"fc{i}"]))
    for name in ("cls_score", "bbox_pred"):
        put(f"predictor.{name}", _dense(params_np["predictor"][name]))
    if arch.learnable_anchors:
        out["anchor_wh"] = _t(params_np["anchor_wh"])
    return out
