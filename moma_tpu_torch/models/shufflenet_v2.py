"""CIFAR ShuffleNetV2.

Counterpart of moma_tpu/models/shufflenet_v2.py (`ShuffleV2`,
`ShuffleV2_1_5`): 1x1 stem to 24 channels, three stages of a two-branch
stride-2 DownBlock then split-half BasicBlocks (channel shuffle, groups
2), a 1x1 head conv.  feats = (stem, the three stages' outputs, pooled),
NHWC; logits float32 from `classifier`.

Each block's concat and shuffle are one copy on the NHWC bytes
(models.common.concat_channels), so every BatchNorm gets a channels_last
tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from moma_tpu_torch.models.common import (ConvBN, TorchLinear,
                                          concat_channels, default_generator,
                                          global_avg_pool)


class BasicBlock(nn.Module):
    """Split-half block: x2 -> 1x1, 3x3 depthwise, 1x1; concat with x1 and
    shuffle (shufflenet_v2.py:39-52)."""

    def __init__(self, channels: int, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        c = channels // 2
        self.c = c
        self.conv1 = ConvBN(c, c, 1, **kw)
        self.conv2 = ConvBN(c, c, 3, groups=c, act=None, **kw)
        self.conv3 = ConvBN(c, c, 1, **kw)

    def forward(self, x):
        x1, x2 = x[:, :self.c], x[:, self.c:]
        y = self.conv3(self.conv2(self.conv1(x2)))
        return concat_channels([x1, y], shuffle_groups=2)


class DownBlock(nn.Module):
    """Left: 3x3 depthwise stride 2, 1x1; right: 1x1, 3x3 depthwise stride
    2, 1x1; concat and shuffle (shufflenet_v2.py:55-70)."""

    def __init__(self, inp: int, out_channels: int, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        mid = out_channels // 2
        self.left = nn.Sequential(
            ConvBN(inp, inp, 3, 2, groups=inp, act=None, **kw),
            ConvBN(inp, mid, 1, **kw))
        self.right = nn.Sequential(
            ConvBN(inp, mid, 1, **kw),
            ConvBN(mid, mid, 3, 2, groups=mid, act=None, **kw),
            ConvBN(mid, mid, 1, **kw))

    def forward(self, x):
        return concat_channels([self.left(x), self.right(x)],
                               shuffle_groups=2)


# the registered sizes of shufflenet_v2.py:73-80
CONFIGS = {
    1: {"out_channels": (116, 232, 464, 1024), "num_blocks": (3, 7, 3)},
    1.5: {"out_channels": (176, 352, 704, 1024), "num_blocks": (3, 7, 3)},
}


class ShuffleNetV2Cifar(nn.Module):
    def __init__(self, net_size: float = 1, num_classes: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        kw = dict(dtype=dtype, generator=g)
        cfg = CONFIGS[net_size]
        out_channels, num_blocks = cfg["out_channels"], cfg["num_blocks"]
        self.stem = ConvBN(3, 24, 1, **kw)
        cin = 24
        stages = []
        for oc, nb in zip(out_channels[:3], num_blocks):
            stages.append(nn.Sequential(
                DownBlock(cin, oc, **kw),
                *[BasicBlock(oc, **kw) for _ in range(nb)]))
            cin = oc
        self.stages = nn.ModuleList(stages)
        self.head = ConvBN(cin, out_channels[3], 1, **kw)
        self.feat_dim = out_channels[3]
        self.classifier = TorchLinear(out_channels[3], num_classes,
                                      generator=g)

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW
        feats = [x]
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        pooled = global_avg_pool(self.head(x))
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def _factory(size):
    def make(num_classes: int = 100, dtype=None, generator=None):
        return ShuffleNetV2Cifar(size, num_classes, dtype, generator)

    return make


ShuffleV2 = _factory(1)
ShuffleV2_1_5 = _factory(1.5)
