"""Probabilistic-Teacher detector (counterpart of the JAX ``modeling/detector.py``).

:class:`PTDetector` is an ``nn.Module`` holding the weights, with the JAX
package's method names and static-shape outputs (padding plus ``valid`` masks):

- :meth:`PTDetector.detect`: the eval path, test-time proposal budgets;
- :meth:`PTDetector.pseudo_labels`: the teacher's weak pass, train-time budgets;
- :meth:`PTDetector.supervised_losses`, :meth:`PTDetector.unsupervised_losses`
  and the fused :meth:`PTDetector.student_losses`: the training losses, with the
  JAX package's stop-gradients (proposals, sampled boxes and matching never carry
  gradient; the learnable anchors get one only through ``mean_p`` of the
  unsupervised RPN box loss).

Inference runs VGG -> Gaussian RPN head -> top-k, decode, clip and exact greedy
NMS -> ROIAlign -> 2xFC box head and predictor -> per-class decode, sigma discount
and class-aware NMS. On the card, ROIAlign (forward and backward) and both NMS
stages are the hand-written CUDA kernels of ``ops/roi_align_cuda.py`` and
``ops/nms_cuda.py``; on the CPU they are their plain PyTorch versions.

Random sampling (RPN anchors, ROI proposals) takes its uniforms from a
:class:`LossDraws` value, or draws them from a ``torch.Generator``: tests pass the
numbers JAX drew.

Deliberate deviations from detectron2 that the JAX package makes and this port
keeps: sigma is gathered by the same top-k index as the proposals before the
rescale ``score *= 1 - mean(sigmoid(sigma))``; detections are discounted by
``1 - sum(sigmoid(sigma)) / 4``; ROIAlign samples a fixed 2x2 grid per bin.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import Arch
from ..ops import boxes as box_ops
from ..ops import losses as L
from ..ops.box_regression import apply_deltas, get_deltas
from ..ops.matcher import masked_iou, match
from ..ops.maxpool_nms import maxpool_keep, maxpool_nms_select
from ..ops.nms_cuda import batched_nms, nms
from ..ops.roi_align_cuda import roi_align
from ..ops.sampling import RowDraws, SampleDraws, draw_rows, draw_uniforms, subsample_labels
from ..ops.sampling import top_desc as _top_desc
from ..parallel.mesh import global_sum
from ..structures import (Detections, GroundTruth, ImageBatch, Proposals, PseudoLabels,
                          resolve_device)
from .anchors_build import anchor_boxes, init_anchor_params, num_cell_anchors
from .backbone import VGG
from .heads import BoxHead, FastRCNNPredictor, RPNHead

__all__ = ["Arch", "LossDraws", "PTDetector"]

# the exact NMS runs for the first three (one CUDA kernel serves the JAX package's two
# formulations); the others change the proposals (``predict_proposals``)
_NMS_IMPLS = ("greedy", "greedy_xla", "pallas", "maxpool", "maxpool_train", "hybrid")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


Rows = Union[SampleDraws, torch.Generator, RowDraws]   # the uniforms of one sampling call
Draws = Union[LossDraws, torch.Generator, RowDraws]


def _sample_draws(draws: Rows, shape, device) -> SampleDraws:
    if isinstance(draws, torch.Generator):
        return draw_uniforms(shape, draws, device)
    if isinstance(draws, RowDraws):
        return draw_rows(draws, shape, device)
    if tuple(draws.pos.shape) != tuple(shape):
        raise ValueError(f"sampling uniforms of shape {tuple(draws.pos.shape)}, need "
                         f"{tuple(shape)}")
    return draws


def _split(draws: Draws):
    """(rpn, roi) draws of a LossDraws, or the generator (or a rank's share of its
    draws) twice."""
    if isinstance(draws, (torch.Generator, RowDraws)):
        return draws, draws
    return draws.rpn, draws.roi


class PTDetector(nn.Module):
    """Binds an :class:`Arch` to the backbone, heads and the inference and loss
    functions.

    Parameters carry the JAX pytree's names (``backbone.block1_conv1.weight``,
    ``rpn_head.conv.weight``, ..., ``anchor_wh``); ``weights.params_from_jax``
    converts a JAX param tree to this module's ``state_dict``. The module runs on
    ``device`` ("cuda" unless the caller names another; no card raises).
    """

    def __init__(self, arch: Arch, device=None):
        super().__init__()
        if arch.rpn_nms_impl not in _NMS_IMPLS:
            raise ValueError(f"MODEL.RPN.NMS_IMPL {arch.rpn_nms_impl!r} is none of {_NMS_IMPLS}")
        self.arch = arch
        self.device = resolve_device(device)
        self.dtype = _DTYPES[arch.compute_dtype]
        self.A = num_cell_anchors(arch)
        in_channels = VGG.out_channels(arch.vgg_depth, arch.feature)
        p = arch.pooler_resolution
        self.backbone = VGG(arch.vgg_depth, arch.feature, self.dtype, arch.freeze_at,
                            arch.remat_backbone)
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
                          grid_hw: Optional[Tuple[int, int]] = None,
                          budget: Optional[Tuple[int, int]] = None) -> Proposals:
        """Top-k by objectness -> decode -> clip -> min-size filter -> sigma-rescored
        exact greedy NMS -> post-NMS budget, for all images at once. No gradient
        flows through the proposals.

        ``MODEL.RPN.NMS_IMPL`` picks another selection when the anchor grid's
        ``grid_hw`` is given (without it, every mode runs the exact path, as in the
        JAX package): ``maxpool`` (``maxpool_train``: training passes only) keeps
        the sigma-rescored local maxima of the grid (:mod:`..ops.maxpool_nms`), with
        no NMS; ``hybrid`` drops the non-maxima of the anchor channels whose
        one-cell diagonal neighbour still overlaps above the NMS threshold, then runs
        the exact NMS on the top ``min(pre, max(2 post, 64))`` candidates.
        """
        a = self.arch
        anchors, obj, deltas = anchors.detach(), obj.detach(), deltas.detach()
        r = obj.shape[1]
        pre = min(budget[0] if budget else a.rpn_pre_nms_topk[int(training)], r)
        post = budget[1] if budget else a.rpn_post_nms_topk[int(training)]
        impl = a.rpn_nms_impl
        hw = image_hw[:, None, :]
        if grid_hw is not None and (impl == "maxpool" or (impl == "maxpool_train" and training)):
            scores = obj * (1.0 - torch.mean(torch.sigmoid(deltas[..., 4:]), dim=-1))
            kidx, kvalid = maxpool_nms_select(scores, grid_hw, self.A, post)
            boxes, ok = self._decode_clip_filter(_gather_rows(deltas, kidx), anchors[kidx], hw)
            return Proposals(boxes, _gather_rows(scores, kidx), kvalid & ok)
        if grid_hw is not None and impl == "hybrid":
            # safe channel: (1 + t)(w - s)(h - s) >= 2 t w h for the offset s = stride,
            # which for w == h means min(w, h) >= s / (1 - sqrt(2 t / (1 + t)))
            t = float(a.rpn_nms_thresh)
            q = float(np.sqrt(2.0 * t / (1.0 + t)))
            safe_min_wh = a.stride / max(1.0 - q, 1e-6)
            cell = (anchors.reshape(grid_hw[0], grid_hw[1], self.A, 4)[0, 0]
                    if anchors.ndim == 2 else anchors)
            ch_safe = torch.minimum(cell[:, 2] - cell[:, 0], cell[:, 3] - cell[:, 1]) >= safe_min_wh
            s_full = obj * (1.0 - torch.mean(torch.sigmoid(deltas[..., 4:]), dim=-1))
            keep = maxpool_keep(s_full.reshape(-1, grid_hw[0], grid_hw[1], self.A),
                                cross_anchor=False)
            keep = (keep | ~ch_safe).reshape(s_full.shape)
            scores, idx = _top_desc(torch.where(keep, s_full, torch.full_like(s_full,
                                                                              float("-inf"))),
                                    min(pre, max(2 * post, 64)))
            boxes, keep = self._decode_clip_filter(_gather_rows(deltas, idx), anchors[idx], hw)
            keep &= torch.isfinite(scores)
        else:
            scores, idx = _top_desc(obj, pre)
            d = _gather_rows(deltas, idx)                        # (N, pre, 8)
            boxes, keep = self._decode_clip_filter(d, anchors[idx], hw)
            keep &= torch.isfinite(scores)
            scores = scores * (1.0 - torch.mean(torch.sigmoid(d[..., 4:]), dim=-1))
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
                                           training=True, grid_hw=feat.shape[1:3], budget=budget)
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
                                           training=False, grid_hw=feat.shape[1:3])
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
        iou = masked_iou(box_ops.pairwise_iou(gt.boxes, anchors_sg), gt.valid)   # (N, G, R)
        midx, labels = match(iou, a.rpn_iou_thresholds, (0, -1, 1), True)
        if a.rpn_boundary_thresh >= 0:
            inside = box_ops.inside_box(anchors_sg, image_hw.float()[:, None, :],
                                        a.rpn_boundary_thresh)
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        pos, neg = subsample_labels(labels.int(), a.rpn_batch_per_image, a.rpn_pos_fraction, 0,
                                    _sample_draws(draws, (n, r), obj.device))
        matched = _gather_rows(gt.boxes, midx).detach()
        obj_loss = L.binary_cross_entropy_with_logits_sum(obj, pos.float(), pos | neg)
        gt_deltas = get_deltas(anchors_sg.expand_as(matched), matched, a.rpn_reg_weights)
        loc_loss = L.prob_box_nll_sum(deltas[..., :4], deltas[..., 4:], gt_deltas, pos,
                                      a.model_type)
        n_all = global_sum(n)
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
        iou = masked_iou(box_ops.pairwise_iou(gt.boxes, all_boxes), gt.valid)   # (N, G, P+G)
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
        total = torch.clamp(global_sum(s_valid.float().sum()), min=1.0)
        loss_box = L.prob_box_nll_sum(sel[..., :4], sel[..., 4:], gt_deltas, s_fg,
                                      a.model_type) / total
        n_all = global_sum(n)
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
                                             / global_sum(proposals.valid.shape[0]))
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
        iou = masked_iou(box_ops.pairwise_iou(pseudo.boxes, anchors_sg), pseudo.valid)
        midx, labels = match(iou, a.rpn_iou_thresholds, (0, -1, 1), True)
        if a.rpn_boundary_thresh >= 0:
            inside = box_ops.inside_box(anchors_sg, image_hw.float()[:, None, :],
                                        a.rpn_boundary_thresh)
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        amask = labels == 1
        t_logits = _gather_rows(pseudo.logits, midx)
        t_sigma = _gather_rows(pseudo.sigma, midx)
        t_boxes = _gather_rows(pseudo.boxes, midx)
        fg = t_logits.argmax(-1) != k
        normalizer = a.rpn_batch_per_image * global_sum(n)
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
        iou = masked_iou(box_ops.pairwise_iou(pseudo.boxes, proposals.boxes), pseudo.valid)
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
        sup["rpn/num_valid_proposals"] = prop_l.valid.float().sum() / global_sum(nl)
        unsup["rpn/num_valid_proposals"] = prop_u.valid.float().sum() / global_sum(nu)
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
