"""The counts behind step_mfu, k1_roofline and k2_roofline, against hand-worked
numbers and the program's own conv count."""

import pytest

from harness import counts

ARCH = {"vgg_depth": 16, "anchor_sizes": [128, 256, 512], "anchor_aspects": [0.5, 1, 2],
        "freeze_at": 2, "num_classes": 8, "pooler_resolution": 7, "fc_dim": 1024, "num_fc": 2,
        "roi_batch_per_image": 512, "unsup_roi_budget": 512, "rpn_post_nms_topk": [1000, 2000],
        "stride": 16}


def test_vgg16_convs_at_600x1200_by_hand():
    # 2 H W 9 Cin Cout per conv; maps 600x1200, 300x600, 150x300, 75x150, 37x75
    by_hand = 2 * 9 * (600 * 1200 * (3 * 64 + 64 * 64) + 300 * 600 * (64 * 128 + 128 * 128)
                       + 150 * 300 * (128 * 256 + 2 * 256 * 256)
                       + 75 * 150 * (256 * 512 + 2 * 512 * 512) + 37 * 75 * 3 * 512 * 512)
    blocks, fhw = counts.vgg_flops(600, 1200)
    assert sum(blocks.values()) == by_hand == 439_901_798_400
    assert fhw == (37, 75)


def test_vgg_convs_equal_the_programs_count():
    from probabilisticteacher_torch import roofline
    for h, w in ((600, 1200), (402, 1333), (1024, 2048)):
        ours, _ = counts.vgg_flops(h, w)
        theirs, _ = roofline.conv_flops_per_image(h, w)
        assert ours == theirs


def test_rpn_and_roi_head_by_hand():
    assert counts.rpn_flops(37, 75, 9) == 2 * 37 * 75 * 512 * (9 * 512 + 9 + 72)
    per_roi = 2 * (7 * 7 * 512 * 1024 + 1024 * 1024 + 1024 * 9 + 1024 * 64)
    assert counts.roi_head_flops(8) == per_roi == 53_626_880


def test_iteration_flops():
    img, tr = counts.image_flops(600, 1200, ARCH)
    roi = counts.roi_head_flops(8)
    m = counts.iteration_flops(ARCH, "mutual", 16, 16, (600, 1200), (600, 1200))
    assert m["teacher"] == 16 * img + 16 * 2000 * roi
    assert m["student_forward"] == 48 * img + 48 * 512 * roi
    assert m["student_backward"] == 2 * (48 * tr + 48 * 512 * roi)
    assert m["total"] == pytest.approx(65.21e12, rel=1e-3)
    b = counts.iteration_flops(ARCH, "burnin", 16, 16, (600, 1200), (600, 1200))
    assert b["teacher"] == 0 and b["total"] == 32 * img + 32 * 512 * roi + 2 * (
        32 * tr + 32 * 512 * roi)


def test_k1_k2_bytes_by_hand():
    # 48 x 512 ROIs on a 38 x 84 x 512 bf16 map: output 48*512*49*512*2 B, map 48*38*84*512*2 B
    nbytes = 48 * 512 * 49 * 512 * 2 + 48 * 38 * 84 * 512 * 2 + 48 * 512 * 16
    assert counts.k1_bound_s(48, 512, 38, 84) == pytest.approx(nbytes / 3.35e12)
    assert counts.k2_bound_s(48, 512, 38, 84) == pytest.approx(nbytes / 3.35e12)
    k = counts.kernel_launches(ARCH, "mutual", 16, 16, (608, 1344))
    assert k["k1"] == [counts.k1_bound_s(16, 2000, 38, 84), counts.k1_bound_s(48, 512, 38, 84)]
    assert counts.kernel_launches(ARCH, "burnin", 16, 16, (608, 1344))["k2"] == [
        counts.k2_bound_s(32, 512, 38, 84)]
