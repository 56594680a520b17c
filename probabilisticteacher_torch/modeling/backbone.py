"""VGG backbone (counterpart of the JAX ``modeling/backbone.py``).

Five stages ("vgg_block1".."vgg_block5") of 3x3 convolutions with bias and ReLU;
a 2x2/2 max pool after blocks 1-4 only, so block5 keeps stride 16. Odd trailing
rows and columns are dropped by the pool, as in the JAX package.

Layout: the public input and output are NHWC like the JAX package. Inside, the
convolutions run in ``torch.channels_last``: ``x.permute(0, 3, 1, 2)`` of an NHWC
tensor already is a channels-last NCHW view, and the output's
``permute(0, 2, 3, 1)`` is a contiguous NHWC tensor again, ready for the
ROIAlign kernel, with no copy either way.

Training follows the JAX package in two places:

- the 2x2 max pool's backward splits a window's cotangent evenly among its tied
  maxima (:class:`MaxPool2x2`), where PyTorch's own sends it all to one element;
  under bf16, flat activation regions tie;
- blocks 1..``freeze_at`` pass no gradient back: they run under ``no_grad``,
  which is the JAX package's ``stop_gradient`` after block ``freeze_at`` without
  keeping the frozen stem's activations for a backward that never comes.

Memory: the ReLUs run in place, and the frozen stem runs ``STEM_CHUNK`` images at
a time. At full resolution the stem's activations are a step's largest tensors (a
mutual step's 48 images at 608 x 1344 hold two 4.7 GiB ones in block 1), and
without both the step's peak memory is the stem's, whatever the trainable blocks
keep. Each image's values are the same either way.

``remat`` (``MODEL.BACKBONE.REMAT``, the JAX package's ``jax.checkpoint`` over the
conv stack) runs the blocks after the frozen ones under
``torch.utils.checkpoint``: the backward recomputes their activations instead of
keeping them, through the same :class:`MaxPool2x2`, so the gradients are those
of the plain run.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

STEM_CHUNK = 16     # images per pass through the frozen stem

VGG_STAGES: Dict[int, Sequence[Sequence[int]]] = {
    11: ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    13: ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512)),
    16: ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)),
    19: ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
         (512, 512, 512, 512)),
}


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

    Convolutions compute in ``dtype`` (bf16 under AMP) with weights cast to it,
    as flax casts its f32 params.
    """

    def __init__(self, depth: int = 16, out_feature: str = "vgg_block5",
                 dtype: torch.dtype = torch.float32, freeze_at: int = 0, remat: bool = False):
        super().__init__()
        self.depth = depth
        self.freeze_at = freeze_at
        self.remat = remat
        self.out_feature = out_feature
        self.last_block = int(out_feature.replace("vgg_block", ""))
        self.dtype = dtype
        in_ch = 3
        for bi, channels in enumerate(VGG_STAGES[depth], start=1):
            for ci, ch in enumerate(channels, start=1):
                self.add_module(f"block{bi}_conv{ci}", nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        frozen = min(self.freeze_at, self.last_block)
        if frozen:
            with torch.no_grad():
                if x.shape[0] > STEM_CHUNK:
                    x = torch.cat([self._blocks(c, 1, frozen) for c in x.split(STEM_CHUNK)])
                    x = x.contiguous(memory_format=torch.channels_last)
                else:
                    x = self._blocks(x, 1, frozen)
        if self.remat and torch.is_grad_enabled():
            x = checkpoint(self._blocks, x, frozen + 1, self.last_block, use_reentrant=False)
        else:
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
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                padding=1), inplace=True)
        if bi != self.last_block and bi < 5:  # no pool in block5 -> stride stays 16
            x = MaxPool2x2.apply(x)
        return x

    @staticmethod
    def out_channels(depth: int, feature: str) -> int:
        block = int(feature.replace("vgg_block", ""))
        return VGG_STAGES[depth][block - 1][-1]
