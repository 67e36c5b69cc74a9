"""ImageNet ShuffleNetV2 (torchvision layout).

Counterpart of moma_tpu/models/shufflenet_v2_imagenet.py
(`shufflenet_v2_x0_5` ... `x2_0`): 3x3 stride-2 stem, 3x3 / 2 max-pool
padded 1, three stages of a two-branch stride-2 unit then split-half
units (channel shuffle, groups 2), 1x1 conv5.  feats = (after the
max-pool, stage 2, stage 3, conv5's output, pooled), NHWC — the
reference's taps; logits float32 from `classifier`.

Each unit's concat and shuffle are one copy on the NHWC bytes
(models.common.concat_channels), so every BatchNorm gets a channels_last
tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import (ConvBN, TorchLinear,
                                          concat_channels, default_generator,
                                          global_avg_pool)


class _Unit(nn.Module):
    """torchvision InvertedResidual: the stride-1 split unit or the
    stride-2 unit with both branches (shufflenet_v2_imagenet.py:36-64)."""

    def __init__(self, inp: int, out_channels: int, stride: int, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        branch = out_channels // 2
        self.stride = stride
        if stride == 1:
            self.c = inp // 2
            rin = self.c
        else:
            self.left = nn.Sequential(
                ConvBN(inp, inp, 3, 2, groups=inp, act=None, **kw),
                ConvBN(inp, branch, 1, **kw))
            rin = inp
        self.right = nn.Sequential(
            ConvBN(rin, branch, 1, **kw),
            ConvBN(branch, branch, 3, stride, groups=branch, act=None, **kw),
            ConvBN(branch, branch, 1, **kw))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x[:, :self.c], x[:, self.c:]
            return concat_channels([x1, self.right(x2)], shuffle_groups=2)
        return concat_channels([self.left(x), self.right(x)],
                               shuffle_groups=2)


class ShuffleNetV2ImageNet(nn.Module):
    def __init__(self, stages_repeats: Sequence[int] = (4, 8, 4),
                 stages_out: Sequence[int] = (24, 116, 232, 464, 1024),
                 num_classes: int = 1000,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        kw = dict(dtype=dtype, generator=g)
        so = stages_out
        self.stem = ConvBN(3, so[0], 3, 2, **kw)
        cin = so[0]
        stages = []
        for reps, out_ch in zip(stages_repeats, so[1:4]):
            units = [_Unit(cin, out_ch, 2, **kw)]
            units += [_Unit(out_ch, out_ch, 1, **kw) for _ in range(reps - 1)]
            stages.append(nn.Sequential(*units))
            cin = out_ch
        self.stages = nn.ModuleList(stages)
        self.conv5 = ConvBN(cin, so[4], 1, **kw)
        self.feat_dim = so[4]
        self.classifier = TorchLinear(so[4], num_classes, generator=g)

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW
        x = F.max_pool2d(x, 3, 2, 1)
        feats = [x]
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i < 2:
                feats.append(x)
        x = self.conv5(x)
        feats.append(x)
        pooled = global_avg_pool(x)
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


_SIZES = {
    "x0_5": ((4, 8, 4), (24, 48, 96, 192, 1024)),
    "x1_0": ((4, 8, 4), (24, 116, 232, 464, 1024)),
    "x1_5": ((4, 8, 4), (24, 176, 352, 704, 1024)),
    "x2_0": ((4, 8, 4), (24, 244, 488, 976, 2048)),
}


def _factory(size):
    reps, outs = _SIZES[size]

    def make(num_classes: int = 1000, dtype=None, generator=None):
        return ShuffleNetV2ImageNet(reps, outs, num_classes, dtype, generator)

    return make


shufflenet_v2_x0_5 = _factory("x0_5")
shufflenet_v2_x1_0 = _factory("x1_0")
shufflenet_v2_x1_5 = _factory("x1_5")
shufflenet_v2_x2_0 = _factory("x2_0")
