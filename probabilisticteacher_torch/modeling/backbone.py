"""VGG backbone, forward only (counterpart of the JAX ``modeling/backbone.py``).

Five stages ("vgg_block1".."vgg_block5") of 3x3 convolutions with bias and ReLU;
a 2x2/2 max pool after blocks 1-4 only, so block5 keeps stride 16. Odd trailing
rows and columns are dropped by the pool, as in the JAX package.

Layout: the public input and output are NHWC like the JAX package. Inside, the
convolutions run in ``torch.channels_last``: ``x.permute(0, 3, 1, 2)`` of an NHWC
tensor already is a channels-last NCHW view, and the output's
``permute(0, 2, 3, 1)`` is a contiguous NHWC tensor again, ready for the
ROIAlign kernel, with no copy either way.

The training slice adds the tie-splitting max-pool backward of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

VGG_STAGES: Dict[int, Sequence[Sequence[int]]] = {
    11: ((64,), (128,), (256, 256), (512, 512), (512, 512)),
    13: ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512)),
    16: ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)),
    19: ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512),
         (512, 512, 512, 512)),
}


class VGG(nn.Module):
    """(N, H, W, 3) -> {feature: (N, H/stride, W/stride, C)} for the requested stage.

    Convolutions compute in ``dtype`` (bf16 under AMP) with weights cast to it,
    as flax casts its f32 params.
    """

    def __init__(self, depth: int = 16, out_feature: str = "vgg_block5",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
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
        for bi, channels in enumerate(VGG_STAGES[self.depth], start=1):
            for ci in range(1, len(channels) + 1):
                conv = getattr(self, f"block{bi}_conv{ci}")
                x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                    padding=1))
            if bi == self.last_block:
                break
            if bi < 5:  # no pool in block5 -> stride stays 16
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1)

    @staticmethod
    def out_channels(depth: int, feature: str) -> int:
        block = int(feature.replace("vgg_block", ""))
        return VGG_STAGES[depth][block - 1][-1]
