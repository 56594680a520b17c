"""The weights a run starts from, made by the benchmark from ``--seed``: one draw of
normal numbers on the device from a ``torch.Generator``, cut into the leaves and
scaled leaf by leaf, with the initializers' scales of the program's ``init``: He
fan-out for the backbone (cut at 2 std), 0.01 for the RPN and the class scores,
0.001 for the box deltas, Glorot for the box head, zero biases. Both the program
and the reference load this state dict."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def leaf_std(name: str, shape: Sequence[int]) -> float:
    if name.endswith(".bias"):
        return 0.0
    if name.startswith("backbone."):
        fan_out = shape[0] * math.prod(shape[2:])
        return math.sqrt(2.0 / fan_out)
    if name.startswith("rpn_head.") or name.startswith("predictor.cls_score"):
        return 0.01
    if name.startswith("predictor.bbox_pred"):
        return 0.001
    fan_in = math.prod(shape[1:])
    return math.sqrt(2.0 / (fan_in + shape[0]))


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 fixed: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``} for ``shapes``; ``fixed`` leaves (the anchor
    table, when it is learnable) are copied as given."""
    fixed = fixed or {}
    names = [n for n in shapes if n not in fixed]
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for n in names:
        k = math.prod(shapes[n])
        std = leaf_std(n, shapes[n])
        out[n] = (flat[i:i + k].clamp_(-2.0, 2.0) * std).reshape(shapes[n])
        i += k
    for n, t in fixed.items():
        out[n] = t.to(device=device, dtype=torch.float32).clone()
    return out
