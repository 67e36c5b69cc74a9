"""CIFAR ShuffleNetV1.

Counterpart of moma_tpu/models/shufflenet_v1.py (`ShuffleV1`): 1x1 stem to
24 channels, three stages of bottlenecks (grouped 1x1, channel shuffle,
3x3 depthwise, grouped 1x1); a stage's first, stride-2 unit concatenates a
3x3 / 2 average pool of its input, zero padding counted in the divisor
(torch's AvgPool2d default, shufflenet_v1.py:60-65).  feats = (stem, the
three stages' outputs, pooled), NHWC; logits float32 from `classifier`.

The shuffle and the concatenation run on the maps' NHWC bytes
(models.common.channel_shuffle / concat_channels), so every BatchNorm
still gets a channels_last tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import (BatchNorm, Conv2d, TorchLinear,
                                          channel_shuffle, concat_channels,
                                          default_generator, global_avg_pool)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 groups: int, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        mid = out_planes // 4
        self.g = 1 if in_planes == 24 else groups
        self.stride = stride
        self.conv1 = Conv2d(in_planes, mid, 1, groups=self.g, **kw)
        self.bn1 = BatchNorm(mid, dtype)
        self.conv2 = Conv2d(mid, mid, 3, stride, groups=mid, padding=1, **kw)
        self.bn2 = BatchNorm(mid, dtype)
        self.conv3 = Conv2d(mid, out_planes, 1, groups=groups, **kw)
        self.bn3 = BatchNorm(out_planes, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = channel_shuffle(y, self.g)
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.stride == 2:
            # the padding zeros count in the divisor (AvgPool2d's default);
            # padded explicitly, since on a channels_last CUDA tensor
            # F.avg_pool2d(padding=1) gives wrong input gradients
            # (PyTorch 2.11; tests/test_torch_port_cuda.py)
            res = F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
            return F.relu(concat_channels([y, res]))
        return F.relu(y + x)


class ShuffleNetV1(nn.Module):
    out_planes = (240, 480, 960)
    num_blocks = (4, 8, 4)

    def __init__(self, num_classes: int = 100, groups: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.conv1 = Conv2d(3, 24, 1, dtype=dtype, generator=g)
        self.bn1 = BatchNorm(24, dtype)
        in_planes = 24
        stages = []
        for op, nb in zip(self.out_planes, self.num_blocks):
            blocks = []
            for i in range(nb):
                cat_planes = in_planes if i == 0 else 0
                blocks.append(Bottleneck(in_planes, op - cat_planes,
                                         2 if i == 0 else 1, groups,
                                         dtype, g))
                in_planes = op
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.feat_dim = in_planes
        self.classifier = TorchLinear(in_planes, num_classes, generator=g)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)            # NHWC -> channels_last NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        pooled = global_avg_pool(x)
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def ShuffleV1(num_classes: int = 100, dtype=None, generator=None):
    return ShuffleNetV1(num_classes, dtype=dtype, generator=generator)
