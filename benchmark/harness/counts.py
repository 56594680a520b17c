"""Work counted from the configuration's shapes: the model FLOPs of one training
iteration (``step_mfu``) and the bytes that ROIAlign's forward (K1) and backward (K2)
must move (``k1_roofline``, ``k2_roofline``).

The conv arithmetic is that of ``probabilisticteacher_torch/roofline.py`` as it
stood when the benchmark was written, completed: the RPN head's 1x1 layers count
their real outputs (A objectness + 8 A deltas), and the ROI box head (FC6, FC7 and
the two predictors) is counted at the ROI budgets the configuration fixes. Images
count at the size the loader resizes them to: the canvas padding around them is
not required work. Backward is twice the forward over the trainable part (VGG
blocks after ``freeze_at``, the RPN and the ROI head); nothing recomputed counts.

The peaks are NVIDIA's data-sheet figures for the H100 SXM at 700 W: 989 TFLOP/s
dense bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

VGG_STAGES = {
    11: ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    13: ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512)),
    16: ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)),
    19: ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
         (512, 512, 512, 512)),
}


def vgg_flops(h: int, w: int, depth: int = 16) -> Tuple[Dict[int, int], Tuple[int, int]]:
    """Forward FLOPs of each VGG block's 3x3 convolutions on an (h, w) image, and the
    stride-16 map's (h, w); a 2x2 pool halves the map after blocks 1-4."""
    flops, cin = {}, 3
    for blk, chans in enumerate(VGG_STAGES[depth], start=1):
        f = 0
        for cout in chans:
            f += 2 * h * w * 9 * cin * cout
            cin = cout
        flops[blk] = f
        if blk < 5:
            h, w = h // 2, w // 2
    return flops, (h, w)


def rpn_flops(fh: int, fw: int, anchors: int, channels: int = 512, box_dim: int = 8) -> int:
    """The RPN head on the stride-16 map: the 3x3 conv, then 1x1 objectness (A) and
    deltas (box_dim A)."""
    return 2 * fh * fw * channels * (9 * channels + anchors * (1 + box_dim))


def roi_head_flops(num_classes: int, pool: int = 7, channels: int = 512, fc_dim: int = 1024,
                   num_fc: int = 2, box_dim: int = 8) -> int:
    """One ROI through the box head: FC6 on the pooled (pool, pool, channels) block,
    the further FCs, the class scores (K + 1) and the box outputs (box_dim K)."""
    f = 2 * pool * pool * channels * fc_dim + 2 * (num_fc - 1) * fc_dim * fc_dim
    return f + 2 * fc_dim * (num_classes + 1 + box_dim * num_classes)


def image_flops(h: int, w: int, arch: Dict) -> Tuple[int, int]:
    """(all, trainable) forward FLOPs of the backbone and RPN on one (h, w) image."""
    blocks, (fh, fw) = vgg_flops(h, w, arch["vgg_depth"])
    a = len(arch["anchor_sizes"]) * len(arch["anchor_aspects"])
    rpn = rpn_flops(fh, fw, a)
    trainable = sum(f for b, f in blocks.items() if b > arch["freeze_at"]) + rpn
    return sum(blocks.values()) + rpn, trainable


def iteration_flops(arch: Dict, phase: str, n_l: int, n_u: int,
                    hw_l: Sequence[int], hw_u: Sequence[int]) -> Dict[str, int]:
    """Model FLOPs of one iteration: the teacher forward on the n_u unlabeled images
    (mutual), the student forward on 2 n_l labeled views (+ n_u unlabeled in a mutual
    step), and the student backward at twice the trainable forward."""
    roi = roi_head_flops(arch["num_classes"], arch["pooler_resolution"],
                         fc_dim=arch["fc_dim"], num_fc=arch["num_fc"])
    all_l, tr_l = image_flops(*hw_l, arch)
    all_u, tr_u = image_flops(*hw_u, arch)
    student_rois = 2 * n_l * arch["roi_batch_per_image"]
    fwd = 2 * n_l * all_l
    train = 2 * n_l * tr_l
    teacher = 0
    if phase == "mutual":
        teacher = n_u * all_u + n_u * arch["rpn_post_nms_topk"][1] * roi
        fwd += n_u * all_u
        train += n_u * tr_u
        student_rois += n_u * arch["unsup_roi_budget"]
    fwd += student_rois * roi
    train += student_rois * roi
    return {"teacher": teacher, "student_forward": fwd, "student_backward": 2 * train,
            "total": teacher + fwd + 2 * train}


def k1_bound_s(n: int, r: int, fh: int, fw: int, c: int = 512, pool: int = 7,
               elem: int = 2) -> float:
    """Least time of one K1 launch: the feature maps and boxes read once and the
    pooled output written once at the HBM rate, or its f32 operations (4 samples x 4
    taps, a multiply and an add each, and the mean: 33 per output) at the f32 rate,
    whichever is longer."""
    nbytes = (n * fh * fw * c + n * r * pool * pool * c) * elem + n * r * 4 * 4
    ops = n * r * pool * pool * c * 33
    return max(nbytes / H100_HBM_BYTES, ops / H100_F32_FLOPS)


def k2_bound_s(n: int, r: int, fh: int, fw: int, c: int = 512, pool: int = 7,
               elem: int = 2) -> float:
    """Least time of one K2 launch: the output gradient and boxes read once and dF
    written once at the HBM rate (its operations depend on where the boxes fall, so
    only the bytes bound it here)."""
    nbytes = n * r * pool * pool * c * elem + n * r * 4 * 4 + n * fh * fw * c * elem
    return nbytes / H100_HBM_BYTES


def kernel_launches(arch: Dict, phase: str, n_l: int, n_u: int,
                    canvas: Sequence[int]) -> Dict[str, list]:
    """The K1 and K2 launches of one iteration with their least times: the teacher's
    ROIAlign over n_u x POST_NMS_TOPK_TRAIN proposals, and the student's over its
    sampled ROIs (one launch while the labeled and unlabeled budgets are equal), and
    the student's backward."""
    fh, fw = canvas[0] // arch["stride"], canvas[1] // arch["stride"]
    p = arch["pooler_resolution"]
    k1, k2 = [], []
    rois = arch["roi_batch_per_image"]
    if phase == "mutual":
        k1.append(k1_bound_s(n_u, arch["rpn_post_nms_topk"][1], fh, fw, pool=p))
        if arch["unsup_roi_budget"] == rois:
            k1.append(k1_bound_s(2 * n_l + n_u, rois, fh, fw, pool=p))
            k2.append(k2_bound_s(2 * n_l + n_u, rois, fh, fw, pool=p))
        else:
            k1 += [k1_bound_s(2 * n_l, rois, fh, fw, pool=p),
                   k1_bound_s(n_u, arch["unsup_roi_budget"], fh, fw, pool=p)]
            k2 += [k2_bound_s(2 * n_l, rois, fh, fw, pool=p),
                   k2_bound_s(n_u, arch["unsup_roi_budget"], fh, fw, pool=p)]
    else:
        k1.append(k1_bound_s(2 * n_l, rois, fh, fw, pool=p))
        k2.append(k2_bound_s(2 * n_l, rois, fh, fw, pool=p))
    return {"k1": k1, "k2": k2}
