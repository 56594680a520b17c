"""Probabilistic-Teacher detector, inference slice (counterpart of the JAX
``modeling/detector.py``).

:class:`PTDetector` is an ``nn.Module`` holding the weights, with the JAX
package's method names and static-shape outputs (padding plus ``valid`` masks):

- :meth:`PTDetector.detect`: the eval path, test-time proposal budgets;
- :meth:`PTDetector.pseudo_labels`: the teacher's weak pass, train-time budgets.

Both run VGG -> Gaussian RPN head -> top-k, decode, clip and exact greedy NMS ->
ROIAlign -> 2xFC box head and predictor -> per-class decode, sigma discount and
class-aware NMS. On the card, ROIAlign and both NMS stages are the hand-written
CUDA kernels of ``ops/roi_align_cuda.py`` and ``ops/nms_cuda.py``; on the CPU
they are their plain PyTorch versions. The training losses come in a later slice.

Deliberate deviations from detectron2 that the JAX package makes and this port
keeps: sigma is gathered by the same top-k index as the proposals before the
rescale ``score *= 1 - mean(sigmoid(sigma))``; detections are discounted by
``1 - sum(sigmoid(sigma)) / 4``; ROIAlign samples a fixed 2x2 grid per bin.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Arch
from ..ops import boxes as box_ops
from ..ops.box_regression import apply_deltas
from ..ops.nms_cuda import batched_nms, nms
from ..ops.roi_align_cuda import roi_align
from ..structures import Detections, ImageBatch, Proposals, PseudoLabels, resolve_device
from .anchors_build import anchor_boxes, init_anchor_params, num_cell_anchors
from .backbone import VGG
from .heads import BoxHead, FastRCNNPredictor, RPNHead

__all__ = ["Arch", "PTDetector"]

_EXACT_NMS = ("greedy", "greedy_xla", "pallas")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, K, ...) gathered along dim 1 by idx (N, M) -> (N, M, ...)."""
    idx = idx.to(torch.int64)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _top_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: descending, the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class PTDetector(nn.Module):
    """Binds an :class:`Arch` to the backbone, heads and the inference functions.

    Parameters carry the JAX pytree's names (``backbone.block1_conv1.weight``,
    ``rpn_head.conv.weight``, ..., ``anchor_wh``); ``weights.params_from_jax``
    converts a JAX param tree to this module's ``state_dict``. The module runs on
    ``device`` ("cuda" unless the caller names another; no card raises).
    """

    def __init__(self, arch: Arch, device=None):
        super().__init__()
        if arch.rpn_nms_impl not in _EXACT_NMS:
            raise NotImplementedError(
                f"MODEL.RPN.NMS_IMPL {arch.rpn_nms_impl!r} is not ported yet (ROADMAP A13); "
                f"the port runs the exact NMS for {_EXACT_NMS}")
        self.arch = arch
        self.device = resolve_device(device)
        self.dtype = _DTYPES[arch.compute_dtype]
        self.A = num_cell_anchors(arch)
        in_channels = VGG.out_channels(arch.vgg_depth, arch.feature)
        p = arch.pooler_resolution
        self.backbone = VGG(arch.vgg_depth, arch.feature, self.dtype)
        self.rpn_head = RPNHead(self.A, 8, in_channels, self.dtype)
        self.box_head = BoxHead(p * p * in_channels, arch.fc_dim, arch.num_fc, self.dtype)
        self.predictor = FastRCNNPredictor(arch.fc_dim, arch.num_classes, 8)
        wh = init_anchor_params(arch)
        self.anchor_wh = None if wh is None else nn.Parameter(torch.from_numpy(wh))
        self.to(self.device)

    # ----------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Draw every weight from ``seed`` with the JAX package's initializers
        (He fan-out truncated normal for the backbone, normal 0.01 for the RPN and
        the class scores, 0.001 for the box deltas, Xavier uniform for the box
        head, zero biases) and return the state dict. The numbers differ from
        JAX's for the same seed; tests carry JAX weights over instead."""
        g = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if not isinstance(mod, (nn.Conv2d, nn.Linear)):
                continue
            w = torch.empty(mod.weight.shape)
            if name.startswith("backbone."):
                fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                std = (2.0 / fan_out) ** 0.5 / 0.87962566103423978  # truncated at 2 std
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
            elif name.startswith("rpn_head.") or name == "predictor.cls_score":
                nn.init.normal_(w, 0.0, 0.01, generator=g)
            elif name == "predictor.bbox_pred":
                nn.init.normal_(w, 0.0, 0.001, generator=g)
            else:
                nn.init.xavier_uniform_(w, generator=g)
            mod.weight.copy_(w)
            mod.bias.zero_()
        if self.anchor_wh is not None:
            self.anchor_wh.copy_(torch.from_numpy(init_anchor_params(self.arch)))
        return self.state_dict()

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
        """-> (N, H/stride, W/stride, C) in the compute dtype, contiguous NHWC."""
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
        pooled = roi_align(feat, boxes, 1.0 / a.stride, a.pooler_resolution,
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
        boxes = box_ops.clip_boxes(boxes, hw)
        keep = box_ops.nonempty(boxes, a.rpn_min_size)
        keep &= torch.isfinite(boxes).all(dim=-1)
        return boxes, keep

    def predict_proposals(self, anchors: torch.Tensor, obj: torch.Tensor, deltas: torch.Tensor,
                          image_hw: torch.Tensor, training: bool,
                          budget: Optional[Tuple[int, int]] = None) -> Proposals:
        """Top-k by objectness -> decode -> clip -> min-size filter -> sigma-rescored
        exact greedy NMS -> post-NMS budget, for all images at once."""
        a = self.arch
        r = obj.shape[1]
        pre = min(budget[0] if budget else a.rpn_pre_nms_topk[int(training)], r)
        post = budget[1] if budget else a.rpn_post_nms_topk[int(training)]
        scores, idx = _top_desc(obj, pre)
        d = _gather_rows(deltas, idx)                        # (N, pre, 8)
        anc = anchors[idx]                                    # (N, pre, 4)
        boxes, keep = self._decode_clip_filter(d, anc, image_hw[:, None, :])
        keep &= torch.isfinite(scores)
        rescale = 1.0 - torch.mean(torch.sigmoid(d[..., 4:]), dim=-1)
        scores = scores * rescale
        kidx, kvalid = nms(boxes, scores, keep, a.rpn_nms_thresh, post)
        return Proposals(_gather_rows(boxes, kidx), _gather_rows(scores, kidx), kvalid)

    # ----------------------------------------------------------- entry points
    @torch.no_grad()
    def pseudo_labels(self, images: ImageBatch) -> PseudoLabels:
        """The teacher's weak pass: train-time RPN budgets (or the teacher's own,
        when set) -> ROI inference with sigma-discounted scores."""
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
                                           training=True, budget=budget)
        det = self._roi_inference(feat, proposals, images.image_hw,
                                  nms_candidates=a.teacher_nms_candidates)
        return PseudoLabels(boxes=det.boxes, logits=det.logits, sigma=det.sigma,
                            valid=det.valid)

    @torch.no_grad()
    def detect(self, images: ImageBatch) -> Detections:
        """The eval path: test-time proposal budgets -> ROI inference."""
        feat = self.features(images)
        obj, deltas = self.rpn_predict(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2])
        proposals = self.predict_proposals(anchors, obj, deltas, images.image_hw,
                                           training=False)
        return self._roi_inference(feat, proposals, images.image_hw)

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
        boxes = box_ops.clip_boxes(boxes, image_hw.float()[:, None, None, :])
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
