"""Conv-FLOP roofline of one mutual iteration (the port of ``scripts/roofline.py``).

    python -m probabilisticteacher_torch.roofline [--canvas 608x1216] [--batch 8]
        [--peak-tfs 989] [--eff 1.0,1.0] [--measured-step-ms MS]

Pure arithmetic over the shapes, so the count can be audited by hand. One mutual
iteration at B labeled + B unlabeled images (the reference's accounting,
``pt/engine/trainer.py:263-392``) runs:

- the teacher forward on B images, with no gradient;
- the fused student forward on 3 B images (2 B labeled views, B unlabeled);
- the student backward, data and weight gradients at 2x the forward, with blocks
  1-2 excluded: the frozen stem (``FREEZE_AT`` 2) passes no gradient.

Counted: every 3x3 convolution of the VGG blocks, and the RPN head's 3x3 conv and
1x1 heads on the stride-16 map, at ``2 * H * W * k * k * C_in * C_out`` each, as the
JAX script counts them. The ROI heads, ROIAlign, NMS, the augmentation and the
elementwise work are not counted: the share of the card's peak that the count gives
(:func:`conv_mfu`) is a share of the step's conv work only.

The peak defaults to 989 TFLOP/s, NVIDIA's dense bf16 figure for the H100 SXM at
700 W. The efficiencies (the fraction of the peak that blocks 1-2 and blocks 3-5
with the RPN reach) default to 1.0: only a profile of the card can set them.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

from .modeling.backbone import VGG_STAGES
from .structures import card_line

H100_BF16_DENSE_TFS = 989.0
FROZEN_BLOCKS = (1, 2)          # FREEZE_AT 2: no backward through blocks 1-2
RPN_CHANNELS = 512


def conv_flops_per_image(h: int, w: int,
                         depth: int = 16) -> Tuple[Dict[int, int], Tuple[int, int]]:
    """Forward FLOPs of each VGG block's convolutions on one (h, w) image, and the
    final feature map's (h, w); a 2x2 pool halves the map after blocks 1-4."""
    flops = {}
    cin = 3
    for blk, chans in enumerate(VGG_STAGES[depth], start=1):
        f = 0
        for cout in chans:
            f += 2 * h * w * 9 * cin * cout
            cin = cout
        flops[blk] = f
        if blk < 5:
            h, w = h // 2, w // 2
    return flops, (h, w)


def rpn_flops(fh: int, fw: int) -> int:
    """The RPN head on the stride-16 map: the 3x3 conv and the 1x1 heads, counted as
    the JAX script counts them (``512 * 15 * 9`` for the heads)."""
    return 2 * fh * fw * (9 * RPN_CHANNELS * RPN_CHANNELS + RPN_CHANNELS * 15 * 9)


def iteration(h: int, w: int, batch: int, depth: int = 16,
              peak_tfs: float = H100_BF16_DENSE_TFS,
              eff: Sequence[float] = (1.0, 1.0)) -> dict:
    """One mutual iteration's conv work at ``batch`` + ``batch`` images on an
    (h, w) canvas: FLOPs forward and backward, the conv-only time at the given
    efficiencies of ``peak_tfs``, and the images/s ceilings (4 B images an
    iteration, ``bench.py``'s rule)."""
    fb, (fh, fw) = conv_flops_per_image(h, w, depth)
    rpn = rpn_flops(fh, fw)
    trainable = sum(f for b, f in fb.items() if b not in FROZEN_BLOCKS) + rpn
    fwd = 4 * batch * (sum(fb.values()) + rpn)          # teacher B + student 3 B
    bwd = 3 * batch * 2 * trainable                     # student only
    e12, e35 = eff
    peak = peak_tfs * 1e12
    t12 = sum(fb[b] for b in FROZEN_BLOCKS) / (peak * e12)
    t35 = trainable / (peak * e35)
    conv_s = 4 * batch * (t12 + t35) + 3 * batch * 2 * t35
    return {"canvas": (h, w), "batch": batch, "block_flops": fb, "rpn_flops": rpn,
            "fwd_flops": fwd, "bwd_flops": bwd, "flops": fwd + bwd,
            "peak_tfs": peak_tfs, "eff": (e12, e35), "conv_ms": conv_s * 1e3,
            "ceiling_img_s": 4 * batch / conv_s,
            "peak_ceiling_img_s": 4 * batch / ((fwd + bwd) / peak)}


def conv_mfu(flops: float, step_ms: float, peak_tfs: float = H100_BF16_DENSE_TFS) -> float:
    """The share of the card's peak that ``flops`` of conv work per step reach in a
    step of ``step_ms``: the conv-only time at the peak over the step's time."""
    return flops / (step_ms / 1e3) / (peak_tfs * 1e12)


def report(r: dict, measured_step_ms: Optional[float] = None) -> str:
    """The JAX script's printout for one :func:`iteration`."""
    h, w = r["canvas"]
    b = r["batch"]
    e12, e35 = r["eff"]
    lines = [
        f"canvas {h}x{w}, batch {b}: conv FLOPs/iter = {r['flops'] / 1e12:.2f} TF "
        f"(fwd {r['fwd_flops'] / 1e12:.2f}, bwd {r['bwd_flops'] / 1e12:.2f})",
        f"blocks 1-2 @ {r['peak_tfs'] * e12:.0f} TF/s, blocks 3-5+RPN @ "
        f"{r['peak_tfs'] * e35:.0f} TF/s -> conv-only time {r['conv_ms']:.1f} ms/iter",
        f"conv-only ceiling: {r['ceiling_img_s']:.1f} img/s/chip (vs 3x-V100 target 165; "
        f"100%-of-peak-everywhere ceiling {r['peak_ceiling_img_s']:.1f})",
    ]
    if measured_step_ms:
        ms = measured_step_ms
        lines.append(f"measured step {ms:.0f} ms -> {4 * b / ms * 1e3:.1f} img/s/chip; "
                     f"non-conv share {(ms - r['conv_ms']) / ms * 100:.0f}%; conv_mfu "
                     f"{conv_mfu(r['flops'], ms, r['peak_tfs']):.3f}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m probabilisticteacher_torch.roofline",
                                description="conv-FLOP roofline of one mutual iteration")
    p.add_argument("--canvas", default="608x1216")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--peak-tfs", type=float, default=H100_BF16_DENSE_TFS,
                   help="the card's dense bf16 peak (H100 SXM: 989 TFLOP/s)")
    p.add_argument("--eff", default="1.0,1.0",
                   help="achieved fraction of the peak for blocks 1-2, blocks 3-5 + RPN")
    p.add_argument("--measured-step-ms", type=float, default=0.0)
    args = p.parse_args(argv)
    h, w = (int(t) for t in args.canvas.split("x"))
    eff = tuple(float(t) for t in args.eff.split(","))
    print(f"card: {card_line()}; peak {args.peak_tfs:g} TFLOP/s bf16 dense")
    print(report(iteration(h, w, args.batch, peak_tfs=args.peak_tfs, eff=eff),
                 args.measured_step_ms))


if __name__ == "__main__":
    main()
