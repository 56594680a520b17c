"""Plain PyTorch operations of the reference: box geometry, box deltas and densities,
the matcher, random subsampling, anchors, the loss primitives, ROIAlign as two
interpolation matmuls, and exact greedy NMS.

A frozen copy of the plain paths of ``probabilisticteacher_torch/ops`` as they stood
when the benchmark was written, with the data-parallel normalizers dropped (the
benchmark runs one process). Nothing here launches a hand-written kernel, and
nothing imports the program.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# ---- ops/boxes.py
def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; last dim 4 -> scalar per box."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., M, 4) and (..., N, 4) boxes -> (..., M, N).

    Degenerate boxes give IoU 0 (guarded division, ``inter > 0`` gate).
    """
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Clip XYXY boxes to [0, w] x [0, h].

    ``image_hw``: (..., 2) as (h, w), broadcastable against ``boxes[..., 0]``.
    """
    h = image_hw[..., 0]
    w = image_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold (detectron2 ``Boxes.nonempty``)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def inside_box(boxes: torch.Tensor, image_hw: torch.Tensor,
               boundary_thresh: float = 0.0) -> torch.Tensor:
    """Mask of boxes fully inside the image plus a margin (the legacy RPN boundary
    filter). ``image_hw`` (..., 2) as (h, w), broadcastable against ``boxes[..., 0]``."""
    h = image_hw[..., 0]
    w = image_hw[..., 1]
    return ((boxes[..., 0] >= -boundary_thresh) & (boxes[..., 1] >= -boundary_thresh)
            & (boxes[..., 2] < w + boundary_thresh) & (boxes[..., 3] < h + boundary_thresh))

# ---- ops/box_regression.py
SCALE_CLAMP = math.log(1000.0 / 16)
SIGMA_CONSTANT = 0.3


def get_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode target boxes as (dx, dy, dw, dh) deltas relative to src boxes.

    Shapes: (..., 4) x (..., 4) -> (..., 4). Zero-size src boxes divide by 1.
    """
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    safe_w = torch.where(src_w != 0, src_w, torch.ones_like(src_w))
    safe_h = torch.where(src_h != 0, src_h, torch.ones_like(src_h))
    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(tgt_w / safe_w + 1e-9)
    dh = wh * torch.log(tgt_h / safe_h + 1e-9)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Decode (..., K*4) deltas against (..., 4) boxes -> (..., K*4) XYXY boxes, in f32."""
    deltas = deltas.float()
    boxes = boxes.float()
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (shape[-1] // 4, 4))

    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(d[..., 3] / wh, max=SCALE_CLAMP)

    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(shape)


def gaussian_dist_pdf(val: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """Gaussian density with the sigma-constant-0.3 normalizer."""
    return torch.exp(-((val - mean) ** 2) / (var + eps) / 2.0) / torch.sqrt(
        2.0 * math.pi * (var + SIGMA_CONSTANT))


def laplace_dist_pdf(val: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     eps: float = 1e-9) -> torch.Tensor:
    """Laplace density with the sigma-constant-0.3 normalizer."""
    return torch.exp(-torch.abs(val - mean) / torch.sqrt(var + eps)) / torch.sqrt(
        4.0 * (var + SIGMA_CONSTANT))


def nll(pdf_vals: torch.Tensor) -> torch.Tensor:
    """-log(pdf + 1e-9), elementwise."""
    return -torch.log(pdf_vals + 1e-9)

# ---- ops/matcher.py
class MatchResult(NamedTuple):
    matched_idx: torch.Tensor  # (..., N) int64 row of the best ground truth
    labels: torch.Tensor       # (..., N) int8 from the matcher's label set


def masked_iou(iou: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """iou (..., M, N), gt_valid (..., M) -> iou with padded rows set to -1."""
    return torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))


def match(iou: torch.Tensor, thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality_matches: bool = False) -> MatchResult:
    """Matcher over an (..., M_gt, N_pred) quality matrix, already gt-masked.

    ``labels`` has one more entry than the ascending ``thresholds`` and labels the
    intervals (-inf, t0), [t0, t1), ..., [t_last, inf). ``torch.argmax`` returns the
    first maximum, as ``jnp.argmax`` does. Low-quality matches: every prediction
    that ties a real ground truth's best IoU gets label 1; its matched index is
    not changed.
    """
    matched_vals, _ = iou.max(dim=-2)
    matched_idx = iou.argmax(dim=-2)
    out = torch.full(matched_vals.shape, labels[0], dtype=torch.int8, device=iou.device)
    for lo, label in zip(thresholds, labels[1:]):
        out = torch.where(matched_vals >= lo, torch.full_like(out, label), out)
    if allow_low_quality_matches:
        highest = iou.max(dim=-1, keepdim=True).values            # (..., M, 1)
        is_best = (iou == highest) & (highest >= 0)
        out = torch.where(is_best.any(dim=-2), torch.ones_like(out), out)
    return MatchResult(matched_idx, out)

# ---- ops/sampling.py
class SampleDraws(NamedTuple):
    """The uniforms of one :func:`subsample_labels` call: (..., N) each."""

    pos: torch.Tensor
    neg: torch.Tensor


def draw_uniforms(shape, generator: Optional[torch.Generator], device) -> SampleDraws:
    """Fresh uniforms for :func:`subsample_labels` over ``shape`` = (..., N)."""
    return SampleDraws(torch.rand(shape, generator=generator, device=device),
                       torch.rand(shape, generator=generator, device=device))


def top_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: descending, the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_idx(keys: torch.Tensor, k: int) -> torch.Tensor:
    return top_desc(keys, k)[1]


def _mask_from_top(keys: torch.Tensor, eligible: torch.Tensor, k: int,
                   budget: torch.Tensor) -> torch.Tensor:
    """Mark the first min(budget, k) of the top-k keys; (..., N) bool."""
    idx = _top_idx(keys, k)
    take = torch.arange(idx.shape[-1], device=keys.device) < budget[..., None]
    mask = torch.zeros_like(eligible)
    return mask.scatter(-1, idx, take)


def random_topk_mask(eligible: torch.Tensor, k: int,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select min(k, #eligible) entries of ``eligible`` (..., N) at random.

    ``u`` (..., N) are the uniform keys. Returns (mask (..., N) bool, count (...)).
    """
    kk = min(k, eligible.shape[-1])
    keys = torch.where(eligible, u, torch.full_like(u, float("-inf")))
    count = torch.clamp(eligible.sum(-1), max=kk)
    return _mask_from_top(keys, eligible, kk, count), count


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     bg_label: int, draws: SampleDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 ``subsample_labels`` with masks; labels (..., N) int.

    Positives are labels not in {-1, bg_label}, negatives are ``bg_label``.
    Samples min(#pos, num_samples * positive_fraction) positives, then
    min(#neg, num_samples - #pos sampled) negatives. The negatives draw a full
    ``num_samples`` top-k and keep its head, as the JAX package does, so the
    same uniforms choose the same rows. Returns (pos_mask, neg_mask).
    """
    positive = (labels != -1) & (labels != bg_label)
    negative = labels == bg_label
    pos_mask, pos_count = random_topk_mask(positive, int(num_samples * positive_fraction),
                                           draws.pos)
    kk = min(num_samples, labels.shape[-1])
    keys = torch.where(negative, draws.neg, torch.full_like(draws.neg, float("-inf")))
    budget = torch.minimum(num_samples - pos_count, negative.sum(-1))
    return pos_mask, _mask_from_top(keys, negative, kk, budget)

# ---- ops/anchors.py
def default_cell_anchors(sizes, aspect_ratios) -> np.ndarray:
    """(len(sizes)*len(aspect_ratios), 4) XYXY anchors centered at (0, 0).

    For area size^2 and aspect a (h/w): w = sqrt(area/a), h = a*w. Ordering: for
    each size, for each aspect ratio.
    """
    anchors = []
    for size in sizes:
        anchor_area = float(size) ** 2
        for a in aspect_ratios:
            w = math.sqrt(anchor_area / a)
            h = a * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def cell_anchors_from_wh(wh_table: torch.Tensor) -> torch.Tensor:
    """Learnable table (A, 2) of (w, h) -> (A, 4) XYXY cell anchors."""
    w = wh_table[:, 0]
    h = wh_table[:, 1]
    return torch.stack([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0], dim=-1)


def grid_anchors(cell_anchors: torch.Tensor, feat_h: int, feat_w: int, stride: int,
                 offset: float = 0.0) -> torch.Tensor:
    """Tile (A, 4) cell anchors over an (feat_h, feat_w) grid -> (H*W*A, 4).

    Row-major over (y, x), anchors fastest: the (H, W, A) order of the RPN head's
    flattened outputs.
    """
    dev = cell_anchors.device
    shifts_x = (torch.arange(feat_w, dtype=torch.float32, device=dev) + offset) * stride
    shifts_y = (torch.arange(feat_h, dtype=torch.float32, device=dev) + offset) * stride
    sx = shifts_x[None, :].expand(feat_h, feat_w).reshape(-1)
    sy = shifts_y[:, None].expand(feat_h, feat_w).reshape(-1)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)  # (H*W, 4)
    return (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4)

# ---- ops/losses.py
def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x)).sum()


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.float().sum(), min=1.0)


def binary_cross_entropy_with_logits_sum(logits: torch.Tensor, targets: torch.Tensor,
                                         mask: torch.Tensor) -> torch.Tensor:
    """Masked sum of BCE-with-logits (RPN objectness), in the stable form
    ``max(x, 0) - x y + log(1 + exp(-|x|))``. ``torch.maximum`` splits the gradient
    of a tie as ``jnp.maximum`` does; ``clamp`` would not."""
    loss = torch.maximum(logits, torch.zeros_like(logits)) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return _masked_sum(loss, mask)


def softmax_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """Masked mean cross entropy over valid rows (ROI supervised classification)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _masked_sum(nll, valid) / _count(valid)


def prob_box_nll_sum(pred_mean: torch.Tensor, pred_sigma_raw: torch.Tensor,
                     gt_deltas: torch.Tensor, mask: torch.Tensor,
                     model_type: str = "GUASSIAN") -> torch.Tensor:
    """Sum over masked rows of -log(pdf(gt_delta; mean, sigmoid(sigma_raw)) + 1e-9)."""
    var = torch.sigmoid(pred_sigma_raw)
    pdf_fn = laplace_dist_pdf if model_type == "LAPLACE" else gaussian_dist_pdf
    nll = -torch.log(pdf_fn(pred_mean, gt_deltas, var) + 1e-9)
    return _masked_sum(nll, mask[..., None].expand_as(nll))


def efl_class_weight(teacher_logits: torch.Tensor, lam: float) -> torch.Tensor:
    """Entropy focal weight from teacher class logits: (1 - H(softmax(t)) / log n) ** lam.

    ``p log p`` is 0 where p underflows to 0 (the double ``where`` keeps its
    gradient finite too)."""
    p = torch.softmax(teacher_logits, dim=-1)
    pos = p > 0
    plogp = torch.where(pos, p * torch.log(torch.where(pos, p, torch.ones_like(p))),
                        torch.zeros_like(p))
    entropy = -plogp.sum(-1)
    return (1.0 - entropy / math.log(teacher_logits.shape[-1])) ** lam


def efl_box_weight(sigma_p: torch.Tensor, lam: float,
                   model_type: str = "GUASSIAN") -> torch.Tensor:
    """Entropy focal weight from the teacher's box variance, before tau scaling."""
    if model_type == "LAPLACE":
        entropy = 1.0 + 0.5 * torch.log(4.0 * sigma_p)
        max_entropy = 1.0 + math.log(2.0)
    else:
        entropy = 0.5 * torch.log(2.0 * math.pi * math.e * sigma_p)
        max_entropy = 0.5 * math.log(2.0 * math.pi * math.e)
    return (1.0 - entropy / max_entropy) ** lam


def rpn_soft_cls_loss(objectness_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      anchor_mask: torch.Tensor, tau0: float, efl: bool,
                      lam0: float) -> torch.Tensor:
    """Unsupervised RPN classification loss, masked sum.

    target = softmax(t / tau0) collapsed to [p_bg, p_fg] (EFL-weighted); per anchor
    sum(target * -log(sigmoid([1 - o, o]) + 1e-9)), the reference's sigmoid(1 - o)
    form.
    """
    p = torch.softmax(teacher_logits / tau0, dim=-1)
    target = torch.stack([p[..., -1], p[..., :-1].sum(-1)], dim=-1)
    if efl:
        target = target * efl_class_weight(teacher_logits, lam0)[..., None]
    o = objectness_logits
    neg_log = -torch.log(torch.sigmoid(torch.stack([1.0 - o, o], dim=-1)) + 1e-9)
    return _masked_sum((target * neg_log).sum(-1), anchor_mask)


def kl_consistency_box_loss(mean_q: torch.Tensor, sigma_q_raw: torch.Tensor,
                            mean_p: torch.Tensor, sigma_p_raw: torch.Tensor,
                            mask: torch.Tensor, tau1: float, efl: bool, lam1: float,
                            model_type: str = "GUASSIAN",
                            reduction: str = "sum") -> torch.Tensor:
    """Teacher -> student box-distribution consistency.

    q is the student (mean, raw sigma), p the teacher (detached by the caller).
    sigma_p = sigmoid(raw) gives the EFL weight, then is scaled by tau1; Gaussian:
    0.5 log(sq / sp) - 0.5 + (sp + (mq - mp)^2) / (2 sq). ``mask`` (...,) selects
    rows; ``reduction`` 'sum' or 'mean' over the masked elements.
    """
    sigma_p = torch.sigmoid(sigma_p_raw)
    if efl:
        w = efl_box_weight(sigma_p, lam1, model_type)
    sigma_p = sigma_p * tau1
    sigma_q = torch.sigmoid(sigma_q_raw)
    if model_type == "LAPLACE":
        diff = torch.abs(mean_q - mean_p)
        loss = (torch.sqrt(sigma_p) * torch.exp(-diff / torch.sqrt(sigma_p))
                / torch.sqrt(sigma_q)
                + diff / torch.sqrt(sigma_q)
                + 0.5 * torch.log(sigma_q / sigma_p)
                - 1.0)
    else:
        loss = (0.5 * torch.log(sigma_q / sigma_p) - 0.5
                + (sigma_p + (mean_q - mean_p) ** 2) / (2.0 * sigma_q))
    if efl:
        loss = loss * w
    loss = torch.where(mask[..., None], loss, torch.zeros_like(loss))
    if reduction == "mean":
        n = torch.clamp(mask.float().sum() * loss.shape[-1], min=1.0)
        return loss.sum() / n
    return loss.sum()


def roi_soft_cls_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      valid: torch.Tensor, tau0: float, efl: bool,
                      lam0: float) -> torch.Tensor:
    """Unsupervised ROI classification loss: per row
    sum(softmax(t / tau0) [* EFL] * -log_softmax(s)), summed over valid rows / #valid."""
    neg_logp = -torch.log_softmax(student_logits, dim=-1)
    soft = torch.softmax(teacher_logits / tau0, dim=-1)
    if efl:
        soft = soft * efl_class_weight(teacher_logits, lam0)[..., None]
    return _masked_sum((soft * neg_logp).sum(-1), valid) / _count(valid)

# ---- ops/roi_align.py
# ROIs per matmul pair: bounds the (chunk, p, W, C) intermediate whatever R is
ROI_CHUNK = 512


def _sample_points(boxes: torch.Tensor, p: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROI bilinear sample coordinates: (R, p*s) for y and x (boxes already scaled).

    The divisors are tensors, not Python numbers: on CUDA, PyTorch divides by a
    Python number as a multiply by its rounded reciprocal, an ulp away from the
    true quotient that JAX and the kernel compute. An ulp can move a sample across
    the out-of-bounds edge, where the result jumps.
    """
    dev = boxes.device
    p_div = torch.tensor(float(p), device=dev)
    s_div = torch.tensor(float(s), device=dev)
    grid_p = torch.arange(p, dtype=torch.float32, device=dev)
    grid_s = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s_div
    off = (grid_p[:, None] + grid_s[None, :]).reshape(-1)  # (p*s,)
    x1, y1, x2, y2 = boxes.unbind(-1)
    ys = y1[:, None] + off[None] * ((y2 - y1) / p_div)[:, None]
    xs = x1[:, None] + off[None] * ((x2 - x1) / p_div)[:, None]
    return ys, xs


def _interp_matrix(points: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear interpolation weights as a dense matrix: (R, K, size).

    W[r, k, i] = weight of source row i for sample k: the 2-tap bilinear weights
    (clip to [0, size-1], zero outside [-1, size]).
    """
    oob = (points < -1.0) | (points > size)
    v = torch.clamp(points, 0.0, float(size - 1))
    i0 = torch.floor(v).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    lo = v - i0.to(v.dtype)
    hi = 1.0 - lo
    ar = torch.arange(size, device=points.device)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    w0 = torch.where(oob, zero, hi)[..., None] * (i0[..., None] == ar)
    w1 = torch.where(oob, zero, lo)[..., None] * (i1[..., None] == ar)
    return w0 + w1


def pool_matrices(boxes: torch.Tensor, h: int, w: int, spatial_scale: float,
                  p: int, s: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (R, 4) -> Wy (R, p, H), Wx (R, p, W), the s samples averaged, in ``dtype``."""
    r = boxes.shape[0]
    scaled = boxes.float() * spatial_scale - 0.5
    ys, xs = _sample_points(scaled, p, s)
    wy = _interp_matrix(ys, h).reshape(r, p, s, h).mean(2)
    wx = _interp_matrix(xs, w).reshape(r, p, s, w).mean(2)
    return wy.to(dtype), wx.to(dtype)


def roi_align_mxu(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                  output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign of one image as two interpolation matmuls.

    features (H, W, C), boxes (R, 4) -> (R, p, p, C) in the feature dtype.
    """
    h, w, c = features.shape
    r = boxes.shape[0]
    p, s = output_size, max(sampling_ratio, 1)
    wy, wx = pool_matrices(boxes, h, w, spatial_scale, p, s, features.dtype)
    # tmp[r, y, w, c] = sum_h wy[r, y, h] * F[h, w, c]
    tmp = (wy.reshape(r * p, h) @ features.reshape(h, w * c)).reshape(r, p, w, c)
    # out[r, y, x, c] = sum_w wx[r, x, w] * tmp[r, y, w, c]
    return torch.einsum("rxw,rywc->ryxc", wx, tmp)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                      output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features (N, H, W, C), boxes (N, R, 4) -> (N, R, p, p, C), in chunks of ROI_CHUNK."""
    n, r = boxes.shape[:2]
    p = output_size
    out = features.new_empty((n, r, p, p, features.shape[-1]))
    for i in range(n):
        for lo in range(0, r, ROI_CHUNK):
            hi = min(lo + ROI_CHUNK, r)
            out[i, lo:hi] = roi_align_mxu(features[i], boxes[i, lo:hi], spatial_scale,
                                          output_size, sampling_ratio)
    return out


def batched_pool_matrices(boxes: torch.Tensor, h: int, w: int, spatial_scale: float, p: int,
                          s: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (N, R, 4) -> Wy (N, R, p, H), Wx (N, R, p, W) in ``dtype``."""
    n, r = boxes.shape[:2]
    wy, wx = pool_matrices(boxes.reshape(n * r, 4), h, w, spatial_scale, p, s, dtype)
    return wy.reshape(n, r, p, h), wx.reshape(n, r, p, w)


def roi_align_bwd_plain(wy: torch.Tensor, wx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d features of ROIAlign: wy (N, R, p, H), wx (N, R, p, W), g (N, R, p, p, C) ->
    dF (N, H, W, C) in the dtype of ``wy`` (the feature dtype).

    Mirrors ``_bwd_einsum``: ``g`` is cast to the feature dtype; the first
    contraction (over the axis whose map side is shorter) rounds its intermediate
    to the feature dtype; the second accumulates in f32 and is cast back once. The
    ROIs go in chunks of ROI_CHUNK per image, so the intermediate stays bounded;
    the chunks' partial sums add up in f32.
    """
    n, r, p, h = wy.shape
    w = wx.shape[-1]
    c = g.shape[-1]
    dt = wy.dtype
    g = g.to(dt)
    out = torch.zeros((n, h, w, c), dtype=torch.float32, device=g.device)
    for i in range(n):
        for lo in range(0, r, ROI_CHUNK):
            hi = min(lo + ROI_CHUNK, r)
            wy_i, wx_i, g_i = wy[i, lo:hi], wx[i, lo:hi], g[i, lo:hi]
            if h <= w:   # wide map: contract the rows first
                u = torch.einsum("rqh,rqxc->rxhc", wy_i, g_i)            # in dt
                out[i] += torch.einsum("rxhc,rxw->hwc", u.float(), wx_i.float())
            else:        # tall map: contract the columns first
                t = torch.einsum("rqxc,rxw->rqwc", g_i, wx_i)            # in dt
                out[i] += torch.einsum("rqh,rqwc->hwc", wy_i.float(), t.float())
    return out.to(dt)

# ---- ops/nms.py
KeepFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float, int], torch.Tensor]


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """(N, K, 4), (N, K), (N, K) -> order (N, K), boxes, areas and valid in that order."""
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    valid_s = torch.gather(valid, 1, order).contiguous()
    return order, boxes_s, area(boxes_s).contiguous(), valid_s


def greedy_keep(boxes_s: torch.Tensor, area_s: torch.Tensor, valid_s: torch.Tensor,
                iou_thresh: float, max_keep: int) -> torch.Tensor:
    """The greedy scan over sorted rows -> keep mask (N, K) bool.

    One step per kept row, all images at once: each image takes its first row
    that is neither suppressed nor already taken, and suppresses the rows whose
    IoU with it exceeds the threshold (``pairwise_iou`` operation for operation).
    """
    n, k = valid_s.shape
    dev = valid_s.device
    rows = torch.arange(n, device=dev)
    t = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = boxes_s.unbind(-1)
    done = ~valid_s            # suppressed or already taken
    keep = torch.zeros_like(valid_s)
    for _ in range(min(max_keep, k)):
        open_rows = ~done
        j = open_rows.to(torch.int8).argmax(dim=1)   # first open row (0 when none)
        found = open_rows[rows, j]
        if not bool(found.any()):
            break
        bj = boxes_s[rows, j]
        iw = torch.minimum(bj[:, 2:3], x1) - torch.maximum(bj[:, 0:1], x0)
        ih = torch.minimum(bj[:, 3:4], y1) - torch.maximum(bj[:, 1:2], y0)
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        union = area_s[rows, j][:, None] + area_s - inter
        iou = torch.where(inter > 0, inter / torch.where(union > 0, union, one), zero)
        done |= (iou > t) & found[:, None]
        done[rows, j] = True
        keep[rows, j] |= found
    return keep


def fixed_buffer(keep: torch.Tensor, order: torch.Tensor,
                 max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept rows in score order -> (N, max_keep) int32 original indices and valid mask."""
    n = keep.shape[0]
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    ok = keep & (pos < max_keep)
    slot = torch.where(ok, pos, torch.full_like(pos, max_keep)).to(torch.int64)
    idx = torch.zeros((n, max_keep + 1), dtype=torch.int32, device=keep.device)
    idx.scatter_(1, slot, order.to(torch.int32))
    valid = torch.zeros((n, max_keep + 1), dtype=torch.bool, device=keep.device)
    valid.scatter_(1, slot, True)
    # column max_keep collects every row that was not kept; it is dropped
    return idx[:, :max_keep], valid[:, :max_keep]


def select(keep_fn: KeepFn, boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_thresh: float, max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort, decide the keep set with ``keep_fn``, and fill the fixed buffer."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    order, boxes_s, area_s, valid_s = sort_by_score(boxes, scores, valid.bool())
    keep = keep_fn(boxes_s, area_s, valid_s, iou_thresh, max_keep)
    idx, ok = fixed_buffer(keep, order, max_keep)
    return (idx[0], ok[0]) if single else (idx, ok)


def class_offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Shift each category's boxes apart so categories never overlap.

    ``max_coord = max(where(valid, boxes, 0)) + 1`` per image, offset
    ``idx * max_coord`` (torchvision ``batched_nms``'s coordinate trick).
    """
    valid = valid.bool()
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., 0]
    return boxes + offsets[..., None]


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
        max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS -> (indices (…, max_keep) int32, valid (…, max_keep) bool)."""
    return select(greedy_keep, boxes, scores, valid, iou_thresh, max_keep)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                valid: torch.Tensor, iou_thresh: float,
                max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS: boxes of different ``idxs`` never suppress each other."""
    return nms(class_offset_boxes(boxes, idxs, valid), scores, valid, iou_thresh, max_keep)
