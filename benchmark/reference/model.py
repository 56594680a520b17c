"""The reference detector: VGG16 Faster R-CNN with the Gaussian RPN and ROI heads of
Probabilistic Teacher, in plain PyTorch and f32.

A frozen copy of the plain paths of ``probabilisticteacher_torch/modeling`` as they
stood when the benchmark was written: the same parameter names (so one state dict
serves the program and the reference), the same static shapes and stop-gradients.
It departs from the program where the program departs from plain f32 arithmetic:

- every convolution and matrix product runs in f32; ``prec`` may round its
  operands to a lower precision (the control of the comparison, ``fp8_e4m3``);
- ROIAlign is the two-matmul interpolation of ``ops.roi_align_mxu`` with its
  transpose as the backward, where the program launches its CUDA kernels K1, K2;
- both NMS stages run the plain greedy scan, where the program launches K3;
- the exact NMS only: the program's ``NMS_IMPL`` levers are not copied;
- no data-parallel normalizers, no REMAT (neither changes a value).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import (apply_deltas, cell_anchors_from_wh, clip_boxes, default_cell_anchors,
                  draw_uniforms, get_deltas, grid_anchors, inside_box, masked_iou, match,
                  nonempty, pairwise_iou, SampleDraws, subsample_labels, nms, batched_nms,
                  batched_pool_matrices, roi_align_batched, roi_align_bwd_plain)
from .ops import top_desc as _top_desc
from . import ops as L


@dataclasses.dataclass(frozen=True)
class Arch:
    """The model's sizes and thresholds; the fields of the program's ``config.Arch``
    that the training path reads."""

    num_classes: int
    vgg_depth: int
    feature: str
    stride: int
    anchor_sizes: Tuple[float, ...]
    anchor_aspects: Tuple[float, ...]
    anchor_offset: float
    learnable_anchors: bool
    anchor_init_wh: Tuple[Tuple[float, float], ...]
    rpn_boundary_thresh: float
    rpn_iou_thresholds: Tuple[float, float]
    rpn_batch_per_image: int
    rpn_pos_fraction: float
    rpn_reg_weights: Tuple[float, ...]
    rpn_pre_nms_topk: Tuple[int, int]
    rpn_post_nms_topk: Tuple[int, int]
    rpn_nms_thresh: float
    rpn_min_size: float
    rpn_loss_weight: float
    roi_iou_threshold: float
    roi_batch_per_image: int
    roi_pos_fraction: float
    roi_reg_weights: Tuple[float, ...]
    pooler_resolution: int
    pooler_sampling_ratio: int
    fc_dim: int
    num_fc: int
    proposal_append_gt: bool
    score_thresh: float
    nms_thresh: float
    detections_per_image: int
    model_type: str
    teacher_pre_nms_topk: int
    teacher_post_nms_topk: int
    teacher_nms_candidates: int
    tau: Tuple[float, float]
    efl: bool
    efl_lambda: Tuple[float, float]
    unsup_roi_budget: int
    pixel_mean: Tuple[float, float, float]
    pixel_std: Tuple[float, float, float]
    rpn_nms_impl: str
    freeze_at: int

    @classmethod
    def from_dict(cls, d: Dict) -> "Arch":
        def tup(v):
            return tuple(tup(x) for x in v) if isinstance(v, (list, tuple)) else v
        return cls(**{f.name: tup(d[f.name]) for f in dataclasses.fields(cls)})


class GroundTruth(NamedTuple):
    boxes: torch.Tensor    # (N, G, 4) XYXY, f32
    classes: torch.Tensor  # (N, G) int32
    valid: torch.Tensor    # (N, G) bool


class PseudoLabels(NamedTuple):
    boxes: torch.Tensor   # (N, T, 4)
    logits: torch.Tensor  # (N, T, K+1)
    sigma: torch.Tensor   # (N, T, 4)
    valid: torch.Tensor   # (N, T)


class Proposals(NamedTuple):
    boxes: torch.Tensor
    logits: torch.Tensor
    valid: torch.Tensor


class Detections(NamedTuple):
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    logits: torch.Tensor
    sigma: torch.Tensor
    valid: torch.Tensor


class ImageBatch(NamedTuple):
    image: torch.Tensor     # (N, H, W, 3) raw 0..255 pixels
    image_hw: torch.Tensor  # (N, 2) valid (h, w)


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest magnitude
    maps to 448), as an fp8 matmul would take it; the gradient passes straight
    through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class RoIAlignPlain(torch.autograd.Function):
    """ROIAlign with d features: the plain forward and its transpose as the backward
    (the boxes get no gradient)."""

    @staticmethod
    def forward(ctx, features, boxes, spatial_scale, output_size, sampling_ratio):
        ctx.save_for_backward(boxes)
        ctx.meta = (tuple(features.shape), features.dtype, spatial_scale, output_size,
                    sampling_ratio)
        return roi_align_batched(features, boxes, spatial_scale, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        (n, h, w, c), dtype, scale, p, s = ctx.meta
        wy, wx = batched_pool_matrices(boxes, h, w, scale, p, max(s, 1), dtype)
        return roi_align_bwd_plain(wy, wx, grad.to(dtype)), None, None, None, None


VGG_STAGES: Dict[int, Sequence[Sequence[int]]] = {
    11: ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    13: ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512)),
    16: ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)),
    19: ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
         (512, 512, 512, 512)),
}


# ---- backbone
STEM_CHUNK = 16     # images per pass through the frozen stem

class MaxPool2x2(torch.autograd.Function):
    """Non-overlapping 2x2/2 max pool on NCHW (odd trailing rows and columns are
    dropped). Backward: the cotangent goes to every element equal to its window's
    maximum, divided by the tie count, so each window routes exactly its cotangent."""

    @staticmethod
    def forward(ctx, x):
        out = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        h, w = x.shape[2], x.shape[3]
        he, we = h - h % 2, w - w % 2

        def up(t):
            return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

        mask = (x[:, :, :he, :we] == up(out)).to(g.dtype)
        cnt = F.avg_pool2d(mask, 2, 2) * 4        # tie count per window, exact
        gx = up(g / cnt) * mask
        if he != h or we != w:
            gx = F.pad(gx, (0, w - we, 0, h - he))
        return gx


class VGG(nn.Module):
    """(N, H, W, 3) -> {feature: (N, H/stride, W/stride, C)} for the requested stage.

    Convolutions compute in f32; ``prec`` rounds each product's operands (the
    identity for the reference, a lower precision for its control).
    """

    def __init__(self, depth: int = 16, out_feature: str = "vgg_block5",
                 prec: Callable[[torch.Tensor], torch.Tensor] = _exact, freeze_at: int = 0):
        super().__init__()
        self.depth = depth
        self.freeze_at = freeze_at
        self.prec = prec
        self.out_feature = out_feature
        self.last_block = int(out_feature.replace("vgg_block", ""))
        in_ch = 3
        for bi, channels in enumerate(VGG_STAGES[depth], start=1):
            for ci, ch in enumerate(channels, start=1):
                self.add_module(f"block{bi}_conv{ci}", nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        frozen = min(self.freeze_at, self.last_block)
        if frozen:
            with torch.no_grad():
                if x.shape[0] > STEM_CHUNK:
                    x = torch.cat([self._blocks(c, 1, frozen) for c in x.split(STEM_CHUNK)])
                    x = x.contiguous(memory_format=torch.channels_last)
                else:
                    x = self._blocks(x, 1, frozen)
        x = self._blocks(x, frozen + 1, self.last_block)
        return x.permute(0, 2, 3, 1)

    def _blocks(self, x: torch.Tensor, first: int, last: int) -> torch.Tensor:
        for bi in range(first, last + 1):
            x = self._block(x, bi)
        return x

    def _block(self, x: torch.Tensor, bi: int) -> torch.Tensor:
        """Block ``bi``'s convolutions, then its pool unless it is the last or block5."""
        for ci in range(1, len(VGG_STAGES[self.depth][bi - 1]) + 1):
            conv = getattr(self, f"block{bi}_conv{ci}")
            x = F.relu(F.conv2d(self.prec(x), self.prec(conv.weight), conv.bias,
                                padding=1), inplace=True)
        if bi != self.last_block and bi < 5:  # no pool in block5 -> stride stays 16
            x = MaxPool2x2.apply(x)
        return x

    @staticmethod
    def out_channels(depth: int, feature: str) -> int:
        block = int(feature.replace("vgg_block", ""))
        return VGG_STAGES[depth][block - 1][-1]



# ---- heads
def _linear(x: torch.Tensor, layer: nn.Linear,
            prec: Callable[[torch.Tensor], torch.Tensor] = _exact) -> torch.Tensor:
    """``x @ W^T + b`` with the product's operands rounded by ``prec``."""
    return F.linear(prec(x), prec(layer.weight)) + layer.bias


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness (A) + 1x1 anchor deltas (A * box_dim)."""

    def __init__(self, num_anchors: int, box_dim: int = 8, conv_dim: int = 512,
                 prec: Callable[[torch.Tensor], torch.Tensor] = _exact):
        super().__init__()
        self.num_anchors = num_anchors
        self.box_dim = box_dim
        self.prec = prec
        self.conv = nn.Conv2d(conv_dim, conv_dim, 3, padding=1)
        self.objectness = nn.Conv2d(conv_dim, num_anchors, 1)
        self.deltas = nn.Conv2d(conv_dim, num_anchors * box_dim, 1)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat (N, H, W, C) -> objectness (N, H*W*A), deltas (N, H*W*A, box_dim), f32.

        The flattening order is (H, W, A), the order of ``grid_anchors``: the NCHW
        conv outputs are permuted back to NHWC before the reshape.
        """
        n, h, w, _ = feat.shape
        q = self.prec
        x = feat.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu(F.conv2d(q(x), q(self.conv.weight), self.conv.bias, padding=1))
        obj = F.conv2d(q(x), q(self.objectness.weight), self.objectness.bias)
        deltas = F.conv2d(q(x), q(self.deltas.weight), self.deltas.bias)
        obj = obj.permute(0, 2, 3, 1).reshape(n, h * w * self.num_anchors)
        deltas = deltas.permute(0, 2, 3, 1).reshape(n, h * w * self.num_anchors, self.box_dim)
        return obj.float(), deltas.float()


class BoxHead(nn.Module):
    """num_fc x FC-fc_dim head over pooled ROI features (FastRCNNConvFCHead, FC only).

    ``fc1`` takes the pooled (P, P, C) block flattened in HWC order, the column
    order of the JAX package's (P*P*C, F) kernel, so the pooled tensor is never
    permuted.
    """

    def __init__(self, in_features: int, fc_dim: int = 1024, num_fc: int = 2,
                 prec: Callable[[torch.Tensor], torch.Tensor] = _exact):
        super().__init__()
        self.prec = prec
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_features if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., P, P, C) -> (..., fc_dim)."""
        x = x.flatten(-3)
        for i in range(self.num_fc):
            x = F.relu(_linear(x, getattr(self, f"fc{i + 1}"), self.prec))
        return x


class FastRCNNPredictor(nn.Module):
    """Gaussian Fast R-CNN outputs: scores (K+1) and box deltas (K * box_dim), in f32."""

    def __init__(self, in_features: int, num_classes: int, box_dim: int = 8):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, num_classes * box_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.float()
        return _linear(x, self.cls_score), _linear(x, self.bbox_pred)



# ---- anchors
def num_cell_anchors(arch) -> int:
    if arch.learnable_anchors:
        return len(arch.anchor_init_wh)
    return len(arch.anchor_sizes) * len(arch.anchor_aspects)


def init_anchor_params(arch) -> Optional[np.ndarray]:
    """Learnable (A, 2) wh table init, or None for the default generator."""
    if not arch.learnable_anchors:
        return None
    return np.asarray(arch.anchor_init_wh, dtype=np.float32)


def anchor_boxes(anchor_wh: Optional[torch.Tensor], arch, feat_h: int, feat_w: int,
                 device=None) -> torch.Tensor:
    """All anchors for one feature map -> (feat_h * feat_w * A, 4) XYXY."""
    if arch.learnable_anchors:
        cell = cell_anchors_from_wh(anchor_wh)
    else:
        cell = torch.as_tensor(
            default_cell_anchors(arch.anchor_sizes, arch.anchor_aspects), device=device)
    return grid_anchors(cell, feat_h, feat_w, arch.stride, arch.anchor_offset)

# ---- detector
# the exact NMS runs for the first three (one CUDA kernel serves the JAX package's two
# formulations); the others change the proposals (``predict_proposals``)
_EXACT_NMS = ("greedy", "greedy_xla", "pallas")


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, K, ...) gathered along dim 1 by idx (N, M) -> (N, M, ...)."""
    idx = idx.to(torch.int64)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _first_k_indices(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k True entries of ``mask`` (..., M) in order, and their
    validity; slots past the True entries hold the lowest False indices."""
    num = mask.shape[-1]
    key = torch.where(mask, -torch.arange(num, dtype=torch.float32, device=mask.device),
                      torch.full(mask.shape, float("-inf"), device=mask.device))
    _, idx = _top_desc(key, min(k, num))
    valid = torch.gather(mask, -1, idx)
    if k > num:  # pad (degenerate: budgets never exceed the row count in practice)
        idx = nn.functional.pad(idx, (0, k - num))
        valid = nn.functional.pad(valid, (0, k - num))
    return idx, valid


def _pick_class(d: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """d (N, S, K, 8), cls (N, S) in [0, K) -> the class's (N, S, 8) row."""
    idx = cls.long()[..., None, None].expand(*cls.shape, 1, d.shape[-1])
    return torch.gather(d, 2, idx)[:, :, 0]


class LossDraws(NamedTuple):
    """The uniforms of one student pass: anchor sampling over (N_l, R) anchors and
    proposal sampling over (N_l, P + G) rows, for the labeled images."""

    rpn: SampleDraws
    roi: SampleDraws


Rows = Union[SampleDraws, torch.Generator]   # the uniforms of one sampling call
Draws = Union[LossDraws, torch.Generator]


def _sample_draws(draws: Rows, shape, device) -> SampleDraws:
    if isinstance(draws, torch.Generator):
        return draw_uniforms(shape, draws, device)
    if tuple(draws.pos.shape) != tuple(shape):
        raise ValueError(f"sampling uniforms of shape {tuple(draws.pos.shape)}, need "
                         f"{tuple(shape)}")
    return draws


def _split(draws: Draws):
    """(rpn, roi) draws of a LossDraws, or the generator twice."""
    if isinstance(draws, torch.Generator):
        return draws, draws
    return draws.rpn, draws.roi


class PTDetector(nn.Module):
    """Binds an :class:`Arch` to the backbone, heads and the inference and loss
    functions.

    Parameters carry the program's names (``backbone.block1_conv1.weight``,
    ``rpn_head.conv.weight``, ..., ``anchor_wh``), so one state dict loads into both.
    """

    def __init__(self, arch: Arch, device,
                 prec: Callable[[torch.Tensor], torch.Tensor] = _exact):
        super().__init__()
        if arch.rpn_nms_impl not in _EXACT_NMS:
            raise ValueError(f"the reference runs the exact NMS only, not {arch.rpn_nms_impl!r}")
        self.arch = arch
        self.device = torch.device(device)
        self.A = num_cell_anchors(arch)
        in_channels = VGG.out_channels(arch.vgg_depth, arch.feature)
        p = arch.pooler_resolution
        self.backbone = VGG(arch.vgg_depth, arch.feature, prec, arch.freeze_at)
        self.rpn_head = RPNHead(self.A, 8, in_channels, prec)
        self.box_head = BoxHead(p * p * in_channels, arch.fc_dim, arch.num_fc, prec)
        self.predictor = FastRCNNPredictor(arch.fc_dim, arch.num_classes, 8)
        wh = init_anchor_params(arch)
        self.anchor_wh = None if wh is None else nn.Parameter(torch.from_numpy(wh))
        self.to(self.device)

    # ------------------------------------------------------------ primitives
    def preprocess(self, images: ImageBatch) -> torch.Tensor:
        """Normalize raw pixels (Caffe-BGR mean/std) and zero the padding; NHWC f32."""
        dev = images.image.device
        mean = torch.tensor(self.arch.pixel_mean, dtype=torch.float32, device=dev)
        std = torch.tensor(self.arch.pixel_std, dtype=torch.float32, device=dev)
        x = (images.image.float() - mean) / std
        _, h, w, _ = x.shape
        ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        hw = images.image_hw.float()
        valid = (ys < hw[:, 0][:, None, None]) & (xs < hw[:, 1][:, None, None])
        return x * valid[..., None]

    def features(self, images: ImageBatch) -> torch.Tensor:
        """-> (N, H/stride, W/stride, C) f32, NHWC."""
        return self.backbone(self.preprocess(images))

    def anchors(self, feat_h: int, feat_w: int) -> torch.Tensor:
        return anchor_boxes(self.anchor_wh, self.arch, feat_h, feat_w, device=self.device)

    def rpn_predict(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> objectness (N, R), deltas (N, R, 8), f32."""
        return self.rpn_head(feat)

    def roi_predict(self, feat: torch.Tensor,
                    boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ROIAlign + box head + predictor: boxes (N, B, 4) -> ((N, B, K+1), (N, B, K*8))."""
        a = self.arch
        pooled = RoIAlignPlain.apply(feat, boxes.detach(), 1.0 / a.stride, a.pooler_resolution,
                           a.pooler_sampling_ratio)
        return self.predictor(self.box_head(pooled))

    # ------------------------------------------------------------- proposals
    def _decode_clip_filter(self, d: torch.Tensor, anc: torch.Tensor,
                            hw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode (..., 8) deltas against their anchors, clip to the image, and mask
        boxes that are empty or not finite. ``hw`` broadcasts against ``d[..., 0]``
        with a trailing (h, w) dim."""
        a = self.arch
        boxes = apply_deltas(d[..., :4], anc, a.rpn_reg_weights)
        boxes = clip_boxes(boxes, hw)
        keep = nonempty(boxes, a.rpn_min_size)
        keep &= torch.isfinite(boxes).all(dim=-1)
        return boxes, keep

    def predict_proposals(self, anchors: torch.Tensor, obj: torch.Tensor, deltas: torch.Tensor,
                          image_hw: torch.Tensor, training: bool,
                          grid_hw: Optional[Tuple[int, int]] = None,
                          budget: Optional[Tuple[int, int]] = None) -> Proposals:
        """Top-k by objectness -> decode -> clip -> min-size filter -> sigma-rescored
        exact greedy NMS -> post-NMS budget, for all images at once. No gradient
        flows through the proposals. ``grid_hw`` is accepted for the program's call
        signature; the exact path does not read it."""
        a = self.arch
        anchors, obj, deltas = anchors.detach(), obj.detach(), deltas.detach()
        r = obj.shape[1]
        pre = min(budget[0] if budget else a.rpn_pre_nms_topk[int(training)], r)
        post = budget[1] if budget else a.rpn_post_nms_topk[int(training)]
        hw = image_hw[:, None, :]
        scores, idx = _top_desc(obj, pre)
        d = _gather_rows(deltas, idx)                        # (N, pre, 8)
        boxes, keep = self._decode_clip_filter(d, anchors[idx], hw)
        keep &= torch.isfinite(scores)
        scores = scores * (1.0 - torch.mean(torch.sigmoid(d[..., 4:]), dim=-1))
        kidx, kvalid = nms(boxes, scores, keep, a.rpn_nms_thresh, post)
        return Proposals(_gather_rows(boxes, kidx), _gather_rows(scores, kidx), kvalid)

    # ----------------------------------------------------------- entry points
    @torch.no_grad()
    def pseudo_labels_and_detections(self, images: ImageBatch
                                     ) -> Tuple[PseudoLabels, Detections]:
        """The teacher's weak pass: train-time RPN budgets (or the teacher's own,
        when set) -> ROI inference with sigma-discounted scores; the pseudo-labels and
        the detections they come from."""
        a = self.arch
        budget = None
        if a.teacher_pre_nms_topk > 0 or a.teacher_post_nms_topk > 0:
            budget = (
                a.teacher_pre_nms_topk if a.teacher_pre_nms_topk > 0 else a.rpn_pre_nms_topk[1],
                a.teacher_post_nms_topk if a.teacher_post_nms_topk > 0
                else a.rpn_post_nms_topk[1],
            )
        feat = self.features(images)
        obj, deltas = self.rpn_predict(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2])
        proposals = self.predict_proposals(anchors, obj, deltas, images.image_hw,
                                           training=True, grid_hw=feat.shape[1:3], budget=budget)
        det = self._roi_inference(feat, proposals, images.image_hw,
                                  nms_candidates=a.teacher_nms_candidates)
        return PseudoLabels(det.boxes, det.logits, det.sigma, det.valid), det

    def _roi_inference(self, feat: torch.Tensor, proposals: Proposals, image_hw: torch.Tensor,
                       nms_candidates: int = -1) -> Detections:
        """Softmax minus background -> per-class decode + clip -> score filter on the
        undiscounted probabilities -> sigma discount -> class-aware NMS -> the top
        ``detections_per_image``; keeps the raw class logits and raw sigma.

        ``nms_candidates`` > 0 first keeps only the top-C (proposal, class)
        candidates by score (the teacher's near-exact lever); eval never sets it.
        """
        a = self.arch
        k = a.num_classes
        n, p, _ = proposals.boxes.shape
        logits, pdeltas = self.roi_predict(feat, proposals.boxes)
        probs = torch.softmax(logits, dim=-1)[..., :-1]                   # (N, P, K)
        d = pdeltas.reshape(n, p, k, 8)
        boxes = apply_deltas(d[..., :4].reshape(n, p, k * 4), proposals.boxes,
                             a.roi_reg_weights).reshape(n, p, k, 4)
        boxes = clip_boxes(boxes, image_hw.float()[:, None, None, :])
        sigma = d[..., 4:]                                                # (N, P, K, 4)
        fmask = (probs > a.score_thresh) & proposals.valid[..., None]
        disc = 1.0 - torch.sum(torch.sigmoid(sigma), dim=-1) / 4.0
        flat_boxes = boxes.reshape(n, p * k, 4)
        flat_scores = (probs * disc).reshape(n, p * k)
        flat_valid = fmask.reshape(n, p * k)
        cls_ids = torch.arange(k, dtype=torch.int32, device=feat.device).repeat(p)
        cls_ids = cls_ids[None].expand(n, p * k)
        orig = None
        if 0 < nms_candidates < p * k:
            neg = torch.full_like(flat_scores, float("-inf"))
            _, orig = _top_desc(torch.where(flat_valid, flat_scores, neg), nms_candidates)
            flat_boxes = _gather_rows(flat_boxes, orig)
            flat_scores = _gather_rows(flat_scores, orig)
            flat_valid = _gather_rows(flat_valid, orig)
            cls_ids = _gather_rows(cls_ids, orig)
        kidx, kvalid = batched_nms(flat_boxes, flat_scores, cls_ids, flat_valid, a.nms_thresh,
                                   a.detections_per_image)
        src = kidx if orig is None else _gather_rows(orig, kidx)         # index into P*K
        return Detections(
            boxes=_gather_rows(flat_boxes, kidx),
            scores=_gather_rows(flat_scores, kidx),
            classes=_gather_rows(cls_ids, kidx),
            logits=_gather_rows(logits, src // k),
            sigma=_gather_rows(sigma.reshape(n, p * k, 4), src),
            valid=kvalid,
        )

    # -------------------------------------------------------- supervised losses
    def rpn_supervised_losses(self, anchors: torch.Tensor, obj: torch.Tensor,
                              deltas: torch.Tensor, gt: GroundTruth,
                              draws: Rows,
                              image_hw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Sampled BCE objectness + Gaussian/Laplace NLL box regression, both over
        (batch_per_image * N); ``draws`` are the anchor-sampling uniforms (N, R)."""
        a = self.arch
        n, r = obj.shape
        anchors_sg = anchors.detach()
        iou = masked_iou(pairwise_iou(gt.boxes, anchors_sg), gt.valid)   # (N, G, R)
        midx, labels = match(iou, a.rpn_iou_thresholds, (0, -1, 1), True)
        if a.rpn_boundary_thresh >= 0:
            inside = inside_box(anchors_sg, image_hw.float()[:, None, :],
                                        a.rpn_boundary_thresh)
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        pos, neg = subsample_labels(labels.int(), a.rpn_batch_per_image, a.rpn_pos_fraction, 0,
                                    _sample_draws(draws, (n, r), obj.device))
        matched = _gather_rows(gt.boxes, midx).detach()
        obj_loss = L.binary_cross_entropy_with_logits_sum(obj, pos.float(), pos | neg)
        gt_deltas = get_deltas(anchors_sg.expand_as(matched), matched, a.rpn_reg_weights)
        loc_loss = L.prob_box_nll_sum(deltas[..., :4], deltas[..., 4:], gt_deltas, pos,
                                      a.model_type)
        n_all = n
        normalizer = a.rpn_batch_per_image * n_all
        w = a.rpn_loss_weight
        return {
            "loss_rpn_cls": w * obj_loss / normalizer,
            "loss_rpn_loc": w * loc_loss / normalizer,
            "rpn/num_pos_anchors": pos.sum() / n_all,
            "rpn/num_neg_anchors": neg.sum() / n_all,
        }

    def _sample_rois_sup(self, draws: Rows,
                         proposals: Proposals, gt: GroundTruth):
        """Append the ground truth, IoU-match, and sample ``roi_batch_per_image`` rows
        per image with the positive fraction; ``draws`` are (N, P + G) uniforms."""
        a = self.arch
        if a.proposal_append_gt:
            all_boxes = torch.cat([proposals.boxes, gt.boxes], dim=1)
            all_valid = torch.cat([proposals.valid, gt.valid], dim=1)
        else:
            all_boxes, all_valid = proposals.boxes, proposals.valid
        s = a.roi_batch_per_image
        k = a.num_classes
        iou = masked_iou(pairwise_iou(gt.boxes, all_boxes), gt.valid)   # (N, G, P+G)
        midx, labels = match(iou, (a.roi_iou_threshold,), (0, 1), False)
        cls = torch.where(labels == 1, torch.gather(gt.classes, 1, midx).int(),
                          torch.full_like(labels, k, dtype=torch.int32))
        lab = torch.where((labels == 1) & all_valid, 1,
                          torch.where((labels == 0) & all_valid, 0, -1))
        pos, neg = subsample_labels(lab, s, a.roi_pos_fraction, 0,
                                    _sample_draws(draws, tuple(lab.shape), lab.device))
        idx, valid = _first_k_indices(pos | neg, s)
        s_boxes = _gather_rows(all_boxes, idx)
        s_cls = torch.where(valid, torch.gather(cls, 1, idx), torch.full_like(valid, k,
                                                                               dtype=torch.int32))
        s_fg = torch.gather(pos, 1, idx) & valid
        s_matched = _gather_rows(gt.boxes, torch.gather(midx, 1, idx))
        return s_boxes.detach(), s_cls, s_fg, s_matched, valid

    def _roi_sup_loss_tail(self, scores, pdeltas, s_boxes, s_cls, s_fg, s_matched,
                           s_valid) -> Dict[str, torch.Tensor]:
        """Supervised Fast R-CNN losses: mean CE over sampled rows, Gaussian NLL / rows."""
        a = self.arch
        n, s = s_cls.shape
        k = a.num_classes
        loss_cls = L.softmax_cross_entropy_mean(scores, s_cls, s_valid)
        sel = _pick_class(pdeltas.reshape(n, s, k, 8), torch.clamp(s_cls, 0, k - 1))
        gt_deltas = get_deltas(s_boxes, s_matched, a.roi_reg_weights)
        total = torch.clamp(s_valid.float().sum(), min=1.0)
        loss_box = L.prob_box_nll_sum(sel[..., :4], sel[..., 4:], gt_deltas, s_fg,
                                      a.model_type) / total
        n_all = n
        return {
            "loss_cls": loss_cls,
            "loss_box_reg": loss_box,
            "roi_head/num_fg_samples": s_fg.sum() / n_all,
            "roi_head/num_bg_samples": (s_valid & ~s_fg).sum() / n_all,
        }

    def roi_supervised_losses(self, feat: torch.Tensor, proposals: Proposals, gt: GroundTruth,
                              draws: Rows
                              ) -> Dict[str, torch.Tensor]:
        s_boxes, s_cls, s_fg, s_matched, s_valid = self._sample_rois_sup(draws, proposals, gt)
        scores, pdeltas = self.roi_predict(feat, s_boxes)
        return self._roi_sup_loss_tail(scores, pdeltas, s_boxes, s_cls, s_fg, s_matched,
                                       s_valid)

    def supervised_losses(self, images: ImageBatch, gt: GroundTruth,
                          draws: Draws) -> Dict[str, torch.Tensor]:
        """The supervised branch: RPN and ROI supervised losses."""
        d_rpn, d_roi = _split(draws)
        feat = self.features(images)
        obj, deltas = self.rpn_predict(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2]).detach()
        losses = self.rpn_supervised_losses(anchors, obj, deltas, gt, d_rpn, images.image_hw)
        proposals = self.predict_proposals(anchors, obj, deltas, images.image_hw, training=True,
                                           grid_hw=feat.shape[1:3])
        losses["rpn/num_valid_proposals"] = (proposals.valid.float().sum()
                                             / proposals.valid.shape[0])
        losses.update(self.roi_supervised_losses(feat, proposals, gt, d_roi))
        return losses

    # ------------------------------------------------------ unsupervised losses
    def _rpn_unsup_losses(self, anchors: torch.Tensor, anchors_sg: torch.Tensor,
                          obj: torch.Tensor, deltas: torch.Tensor, pseudo: PseudoLabels,
                          image_hw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Soft RPN losses against the teacher's pseudo-labels. ``anchors`` carries
        gradient (anchor adaptation, through ``mean_p``); matching uses ``anchors_sg``."""
        a = self.arch
        k = a.num_classes
        n = obj.shape[0]
        iou = masked_iou(pairwise_iou(pseudo.boxes, anchors_sg), pseudo.valid)
        midx, labels = match(iou, a.rpn_iou_thresholds, (0, -1, 1), True)
        if a.rpn_boundary_thresh >= 0:
            inside = inside_box(anchors_sg, image_hw.float()[:, None, :],
                                        a.rpn_boundary_thresh)
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        amask = labels == 1
        t_logits = _gather_rows(pseudo.logits, midx)
        t_sigma = _gather_rows(pseudo.sigma, midx)
        t_boxes = _gather_rows(pseudo.boxes, midx)
        fg = t_logits.argmax(-1) != k
        normalizer = a.rpn_batch_per_image * n
        loss_rpn_cls = L.rpn_soft_cls_loss(obj, t_logits, amask, a.tau[0], a.efl,
                                           a.efl_lambda[0]) / normalizer
        mean_p = get_deltas(anchors.expand_as(t_boxes), t_boxes, a.rpn_reg_weights)
        loss_rpn_loc = L.kl_consistency_box_loss(
            deltas[..., :4], deltas[..., 4:], mean_p, t_sigma, amask & fg, a.tau[1], a.efl,
            a.efl_lambda[1], a.model_type, "sum") / normalizer
        # unweighted by rpn_loss_weight, as in the reference's unsupervised branch
        return {"loss_rpn_cls": loss_rpn_cls, "loss_rpn_loc": loss_rpn_loc}

    def _keep_rois_unsup(self, proposals: Proposals, pseudo: PseudoLabels):
        """Keep the proposals that match a pseudo box (matcher label 1), the first
        ``unsup_roi_budget`` of them per image."""
        a = self.arch
        iou = masked_iou(pairwise_iou(pseudo.boxes, proposals.boxes), pseudo.valid)
        midx, labels = match(iou, (a.roi_iou_threshold,), (0, 1), False)
        kept = (labels == 1) & proposals.valid
        idx, kvalid = _first_k_indices(kept, a.unsup_roi_budget)
        kmidx = torch.gather(midx, 1, idx)
        return (_gather_rows(proposals.boxes, idx), _gather_rows(pseudo.boxes, kmidx),
                _gather_rows(pseudo.logits, kmidx), _gather_rows(pseudo.sigma, kmidx), kvalid)

    def _roi_unsup_loss_tail(self, scores, pdeltas, k_boxes, k_pboxes, k_logits, k_sigma,
                             k_valid) -> Dict[str, torch.Tensor]:
        """Unsupervised ROI losses: soft CE over the kept rows of the whole batch, and
        the KL box loss on rows whose pseudo class is foreground (mean)."""
        a = self.arch
        k = a.num_classes
        n, b = k_valid.shape
        loss_cls = L.roi_soft_cls_loss(scores.reshape(-1, k + 1), k_logits.reshape(-1, k + 1),
                                       k_valid.reshape(-1), a.tau[0], a.efl, a.efl_lambda[0])
        pseudo_cls = k_logits.argmax(-1)
        fg_rows = k_valid & (pseudo_cls != k)
        sel = _pick_class(pdeltas.reshape(n, b, k, 8), torch.clamp(pseudo_cls, 0, k - 1))
        mean_p_roi = get_deltas(k_boxes, k_pboxes, a.roi_reg_weights)
        loss_box = L.kl_consistency_box_loss(
            sel[..., :4], sel[..., 4:], mean_p_roi, k_sigma, fg_rows, a.tau[1], a.efl,
            a.efl_lambda[1], a.model_type, "mean")
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box}

    def unsupervised_losses(self, images: ImageBatch,
                            pseudo: PseudoLabels) -> Dict[str, torch.Tensor]:
        """The unsupervised branch with anchor adaptation; it samples nothing."""
        feat = self.features(images)
        obj, deltas = self.rpn_predict(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2])     # gradient flows (danchor)
        anchors_sg = anchors.detach()
        losses = self._rpn_unsup_losses(anchors, anchors_sg, obj, deltas, pseudo,
                                        images.image_hw)
        proposals = self.predict_proposals(anchors_sg, obj, deltas, images.image_hw,
                                           training=True, grid_hw=feat.shape[1:3])
        k_boxes, k_pboxes, k_logits, k_sigma, k_valid = self._keep_rois_unsup(proposals, pseudo)
        scores, pdeltas = self.roi_predict(feat, k_boxes)
        losses.update(self._roi_unsup_loss_tail(scores, pdeltas, k_boxes, k_pboxes, k_logits,
                                                k_sigma, k_valid))
        return losses

    # ------------------------------------------------------ fused student pass
    def student_losses(self, images_l: ImageBatch, gt_l: GroundTruth, images_u: ImageBatch,
                       pseudo: PseudoLabels, draws: Draws
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Supervised and unsupervised student losses in one backbone, RPN, NMS and
        ROI pass over the labeled and unlabeled images together.

        A combined batch that is not a multiple of 8 runs the two branches
        separately, as the JAX package does; ``draws`` sample the labeled images
        in both cases.
        """
        a = self.arch
        nl = images_l.image.shape[0]
        nu = images_u.image.shape[0]
        if (nl + nu) % 8 != 0:
            return (self.supervised_losses(images_l, gt_l, draws),
                    self.unsupervised_losses(images_u, pseudo))
        d_rpn, d_roi = _split(draws)
        images = ImageBatch(torch.cat([images_l.image, images_u.image], dim=0),
                            torch.cat([images_l.image_hw, images_u.image_hw], dim=0))
        feat = self.features(images)
        obj, deltas = self.rpn_predict(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2])
        anchors_sg = anchors.detach()
        sup = self.rpn_supervised_losses(anchors_sg, obj[:nl], deltas[:nl], gt_l, d_rpn,
                                         images.image_hw[:nl])
        unsup = self._rpn_unsup_losses(anchors, anchors_sg, obj[nl:], deltas[nl:], pseudo,
                                       images.image_hw[nl:])
        proposals = self.predict_proposals(anchors_sg, obj, deltas, images.image_hw,
                                           training=True, grid_hw=feat.shape[1:3])
        prop_l = Proposals(*(x[:nl] for x in proposals))
        prop_u = Proposals(*(x[nl:] for x in proposals))
        sup["rpn/num_valid_proposals"] = prop_l.valid.float().sum() / nl
        unsup["rpn/num_valid_proposals"] = prop_u.valid.float().sum() / nu
        s_boxes, s_cls, s_fg, s_matched, s_valid = self._sample_rois_sup(d_roi, prop_l, gt_l)
        k_boxes, k_pboxes, k_logits, k_sigma, k_valid = self._keep_rois_unsup(prop_u, pseudo)
        if s_boxes.shape[1] == k_boxes.shape[1]:
            # equal per-image ROI budgets: one ROIAlign + box-head pass
            scores, pdeltas = self.roi_predict(feat, torch.cat([s_boxes, k_boxes], dim=0))
            sc_l, sc_u, pd_l, pd_u = scores[:nl], scores[nl:], pdeltas[:nl], pdeltas[nl:]
        else:
            sc_l, pd_l = self.roi_predict(feat[:nl], s_boxes)
            sc_u, pd_u = self.roi_predict(feat[nl:], k_boxes)
        sup.update(self._roi_sup_loss_tail(sc_l, pd_l, s_boxes, s_cls, s_fg, s_matched,
                                           s_valid))
        unsup.update(self._roi_unsup_loss_tail(sc_u, pd_u, k_boxes, k_pboxes, k_logits,
                                               k_sigma, k_valid))
        return sup, unsup
