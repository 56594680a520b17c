"""What decides ``correct``: the program's first three training iterations, captured
as the timed path produced them, against the plain reference computed again from
the same files, weights and draws.

``NUMBERS`` holds every number that some cell compares; a cell's limits file
(``benchmark/limits/<cell>.json``) names those it holds, and ``compare`` computes
just those (PERF.md gives the readings each limit was set from):

- ``batch``: the largest gap between the batches the loader and prefetcher fed the
  steps (decode, resize, flip, pad) and the reference's: canvas pixels in intensity
  levels, ground-truth boxes in pixels (a difference of shapes, sizes, classes or
  masks reads 1e9);
- ``loss``: every loss term (and the total) of the three steps, the largest gap
  over the larger of the term's and the step's median term's reference value;
- ``grad``: the first step's gradient as the optimizer took it (the momentum trace
  less the weight decay), by the worst leaf: the gap between the program's norm and
  the reference's, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``delta`` and ``delta_median``: the student's parameters' change over the three
  steps, by the worst leaf and by the median leaf, measured alike;
- ``teacher_delta`` (mutual): the EMA teacher's parameters' change over the three
  steps, by the worst leaf (a teacher left unchanged reads 1);
- ``grad_cos_median``: the first gradient's median leaf's 1 - cosine with the
  reference's, blind to the clip's common scale;
- ``rpn_first``: the first step's supervised RPN losses, the larger relative gap;
- ``rpn_out_first``: the student's RPN head outputs (objectness and anchor deltas of
  every image, on each feature level) in the first step, the largest of the
  relative L2 gaps by output and level. The first
  step starts both sides from the same weights on the same images, and no discrete
  choice lies upstream of the head, so only the arithmetic's precision moves it;
- ``pseudo_miss`` (mutual): the share of the reference teacher's detections (class,
  box) that the program's teacher does not give with IoU 0.5 or more (a teacher pass
  over another number of images reads 1).

Leaves whose first gradient in the reference is under a thousandth of the median
leaf's move by weight decay and round-off alone; the leaf gaps leave them out.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

NOUGHT_GRAD = 1e-3     # a leaf below this share of the median leaf's gradient is left out
PSEUDO_IOU = 0.5


class Capture:
    """The first three iterations of one side: batches (host numpy), metrics, the
    teacher's detections (mutual), the student's RPN head outputs in the first
    step (per call, each output as a list of its feature levels), the first
    gradient, and the student's and teacher's change after three steps, per leaf
    (host f32)."""

    def __init__(self):
        self.batches: List[Dict[str, np.ndarray]] = []
        self.metrics: List[Dict[str, float]] = []
        self.dets: List[Dict[str, np.ndarray]] = []
        self.rpn1: List[Tuple[List[torch.Tensor], ...]] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.delta3: Dict[str, torch.Tensor] = {}
        self.teacher3: Dict[str, torch.Tensor] = {}


def record_rpn(cap: Capture):
    """A forward hook for an RPN head that keeps its outputs (objectness, deltas) in
    ``cap``, each as the list of its feature levels: a head that returns one tensor
    per output has one level, one that returns a list per output (a feature
    pyramid) has one per map."""
    def levels(x) -> List[torch.Tensor]:
        x = [x] if isinstance(x, torch.Tensor) else list(x)
        return [t.detach().float().cpu() for t in x]

    def hook(module, inputs, out):
        cap.rpn1.append(tuple(levels(x) for x in out))
    return hook


def params_less(module: torch.nn.Module, p0: Dict[str, torch.Tensor],
                names) -> Dict[str, torch.Tensor]:
    """Each named parameter of ``module`` in ``names`` less its start ``p0``, on the host."""
    return {n: p.detach().float().cpu() - p0[n] for n, p in module.named_parameters()
            if n in names}


def host_batch(limg, lgt, uimg=None) -> Dict[str, np.ndarray]:
    out = {"l_image": limg.image.cpu().numpy(), "l_hw": limg.image_hw.cpu().numpy(),
           "l_boxes": lgt.boxes.cpu().numpy(), "l_classes": lgt.classes.cpu().numpy(),
           "l_valid": lgt.valid.cpu().numpy()}
    if uimg is not None:
        out["u_image"] = uimg.image.cpu().numpy()
        out["u_hw"] = uimg.image_hw.cpu().numpy()
    return out


def host_dets(det) -> Dict[str, np.ndarray]:
    return {"boxes": det.boxes.float().cpu().numpy(), "classes": det.classes.cpu().numpy(),
            "valid": det.valid.cpu().numpy()}


def batch_gap(prog: Capture, ref: Capture) -> float:
    """The largest gap between the batches the program fed its steps and the
    reference's: canvas pixels in intensity levels, ground-truth boxes in pixels; any
    difference of shapes, valid sizes, classes or masks reads 1e9."""
    if len(prog.batches) != len(ref.batches):
        return 1e9
    gap = 0.0
    for p, r in zip(prog.batches, ref.batches):
        if set(p) != set(r) or any(p[k].shape != r[k].shape for k in r):
            return 1e9
        for k in ("l_hw", "u_hw", "l_classes", "l_valid"):
            if k in p and not np.array_equal(p[k], r[k]):
                return 1e9
        for k in ("l_image", "u_image"):
            if k in p:
                gap = max(gap, float(np.abs(p[k].astype(np.int32) - r[k].astype(np.int32)).max()))
        v = r["l_valid"]
        if v.any():
            gap = max(gap, float(np.abs(p["l_boxes"][v] - r["l_boxes"][v]).max()))
    return gap


def loss_gap(prog: Capture, ref: Capture) -> float:
    """Every loss term of the three steps: the largest |prog - ref| over the larger of
    |ref| and the median term's |ref| in that step."""
    worst = 0.0
    if len(prog.metrics) != len(ref.metrics):
        return math.inf
    for p, r in zip(prog.metrics, ref.metrics):
        keys = [k for k in r if k.startswith("loss") or k == "total_loss"]
        if set(keys) - set(p):
            return math.inf
        med = float(np.median([abs(r[k]) for k in keys]))
        for k in keys:
            if not math.isfinite(p[k]):
                return math.inf
            worst = max(worst, abs(p[k] - r[k]) / max(abs(r[k]), med))
    return worst


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def moved_leaves(ref: Capture) -> List[str]:
    """The leaves whose first gradient in the reference is not nought to rounding."""
    g = _norms(ref.grad1)
    med = float(np.median(list(g.values())))
    return [k for k, v in g.items() if v >= NOUGHT_GRAD * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Optional[List[float]]:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref)); None
    where the program lacks a leaf or gives one that is not finite."""
    if set(leaves) - set(prog):
        return None
    p, r = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    if not all(math.isfinite(v) for v in p.values()):
        return None
    med = float(np.median(list(r.values())))
    return [abs(p[k] - r[k]) / max(r[k], med) for k in leaves]


def cosine_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                leaves: Sequence[str]) -> Optional[List[float]]:
    """Each leaf's 1 - cos(prog, ref): the direction's gap, blind to a common scale
    (the clip by global norm scales every leaf of a side alike)."""
    if set(leaves) - set(prog):
        return None
    out = []
    for k in leaves:
        p, r = prog[k].double().flatten(), ref[k].double().flatten()
        out.append(float(1.0 - (p @ r) / (p.norm() * r.norm()).clamp(min=1e-300)))
    return out


def _reduce(gaps: Optional[List[float]], how) -> float:
    return math.inf if gaps is None else float(how(gaps))


def rpn_first_gap(prog: Capture, ref: Capture) -> float:
    """The first step's supervised RPN losses (objectness and box), the larger
    relative gap. They are free of discrete decisions: the anchors' labels come from
    the ground truth and the anchors alone, the sampling from the shared draws, so
    only the arithmetic's precision moves them."""
    if not prog.metrics or not ref.metrics:
        return math.inf
    p, r = prog.metrics[0], ref.metrics[0]
    keys = [k for k in r if k.startswith("loss_rpn_") and not k.endswith("_unsup")]
    if not keys or set(keys) - set(p):
        return math.inf
    return max(abs(p[k] - r[k]) / abs(r[k]) for k in keys)


def rpn_out_gap(prog: Capture, ref: Capture) -> float:
    """The student's RPN head outputs in the first step, each of objectness and
    anchor deltas on each feature level over all its calls and images: the largest
    ||prog - ref|| / ||ref||. Outputs or levels that differ in number or shape read
    inf."""
    if len(prog.rpn1) != len(ref.rpn1) or not ref.rpn1:
        return math.inf
    shape = [len(x) for x in ref.rpn1[0]]
    if any([len(x) for x in c] != shape for c in prog.rpn1 + ref.rpn1):
        return math.inf
    worst = 0.0
    for i, n_levels in enumerate(shape):
        for lv in range(n_levels):
            p = torch.cat([c[i][lv].flatten() for c in prog.rpn1]).double()
            r = torch.cat([c[i][lv].flatten() for c in ref.rpn1]).double()
            if p.shape != r.shape or not bool(torch.isfinite(p).all()):
                return math.inf
            worst = max(worst, float((p - r).norm() / r.norm().clamp(min=1e-300)))
    return worst


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def pseudo_miss(prog: Capture, ref: Capture) -> float:
    """Share of the reference's valid detections with no valid program detection of
    the same class at IoU >= 0.5, over the three steps and all images."""
    missed, total = 0, 0
    if len(prog.dets) != len(ref.dets):
        return 1.0
    for p, r in zip(prog.dets, ref.dets):
        if p["valid"].shape != r["valid"].shape:
            return 1.0
        for i in range(r["valid"].shape[0]):
            rv, pv = r["valid"][i], p["valid"][i]
            rb, rc = r["boxes"][i][rv], r["classes"][i][rv]
            pb, pc = p["boxes"][i][pv], p["classes"][i][pv]
            total += len(rb)
            if len(rb) == 0:
                continue
            if len(pb) == 0:
                missed += len(rb)
                continue
            ok = (_iou(rb, pb) >= PSEUDO_IOU) & (rc[:, None] == pc[None, :])
            missed += int((~ok.any(1)).sum())
    return missed / max(total, 1)


NUMBERS = {
    "batch": lambda p, r, leaves: batch_gap(p, r),
    "loss": lambda p, r, leaves: loss_gap(p, r),
    "grad": lambda p, r, leaves: _reduce(leaf_gaps(p.grad1, r.grad1, leaves), max),
    "delta": lambda p, r, leaves: _reduce(leaf_gaps(p.delta3, r.delta3, leaves), max),
    "delta_median": lambda p, r, leaves: _reduce(leaf_gaps(p.delta3, r.delta3, leaves),
                                                 np.median),
    "teacher_delta": lambda p, r, leaves: _reduce(leaf_gaps(p.teacher3, r.teacher3, leaves),
                                                  max),
    "grad_cos_median": lambda p, r, leaves: _reduce(cosine_gaps(p.grad1, r.grad1, leaves),
                                                    np.median),
    "rpn_first": lambda p, r, leaves: rpn_first_gap(p, r),
    "rpn_out_first": lambda p, r, leaves: rpn_out_gap(p, r),
    "pseudo_miss": lambda p, r, leaves: pseudo_miss(p, r),
}
MUTUAL_ONLY = ("teacher_delta", "pseudo_miss")


def compare(prog: Capture, ref: Capture, names: Iterable[str]) -> Dict[str, float]:
    """The numbers ``names`` (keys of ``NUMBERS``) of the program against the reference."""
    leaves = moved_leaves(ref)
    return {n: float(NUMBERS[n](prog, ref, leaves)) for n in names}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every number that has a limit; a number that is
    not finite, or a limit with no number, fails."""
    out = {}
    for name, limit in limits.items():
        v = float(numbers.get(name, math.inf))
        out[name] = {"value": v if math.isfinite(v) else 1e30, "limit": limit}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
