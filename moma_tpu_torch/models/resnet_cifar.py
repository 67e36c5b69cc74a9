"""CIFAR ResNet / wide-ResNet family.

Counterpart of moma_tpu/models/resnet_cifar.py: depth-6n+2 BasicBlock nets
over widths (16, 16, 32, 64) and their x2 / x4 variants, the 22 factories
(:159-180), and the 9n+2 Bottleneck variant.  Feature contract
(:122-142): feats = (stem after its relu, the three stages' outputs,
pooled), NHWC; logits float32 from `classifier`.

Every 3x3 conv pads (1, 1) on both sides, flax's padding=1; the 1x1
shortcut convs pad nothing.  Submodules are registered in flax call order
(a block's shortcut conv and BN after conv2 / bn2), so
moma_tpu_torch.interop aligns the two parameter trees.  Inside, maps are
NCHW tensors in channels_last memory (NHWC bytes).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import (BatchNorm, Conv2d, TorchLinear,
                                          default_generator, global_avg_pool)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, **kw)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm(planes, dtype)
        self.shortcut = None
        if stride != 1 or inplanes != planes:
            self.shortcut = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, **kw),
                BatchNorm(planes, dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, **kw)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride, padding=1, **kw)
        self.bn2 = BatchNorm(planes, dtype)
        self.conv3 = Conv2d(planes, out, 1, **kw)
        self.bn3 = BatchNorm(out, dtype)
        self.shortcut = None
        if stride != 1 or inplanes != out:
            self.shortcut = nn.Sequential(Conv2d(inplanes, out, 1, stride,
                                                 **kw),
                                          BatchNorm(out, dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + res)


class ResNetCifar(nn.Module):
    """3-stage CIFAR ResNet; depth = 6n+2 (basic) or 9n+2 (bottleneck).
    forward(NHWC images) -> (feats, logits)."""

    def __init__(self, depth: int, num_filters: Sequence[int],
                 block_name: str = "basicblock", num_classes: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        if block_name.lower() == "basicblock":
            assert (depth - 2) % 6 == 0, "basicblock depth must be 6n+2"
            n, block = (depth - 2) // 6, BasicBlock
        elif block_name.lower() == "bottleneck":
            assert (depth - 2) % 9 == 0, "bottleneck depth must be 9n+2"
            n, block = (depth - 2) // 9, Bottleneck
        else:
            raise ValueError(f"unknown block {block_name}")
        self.conv1 = Conv2d(3, num_filters[0], 3, padding=1, dtype=dtype,
                            generator=g)
        self.bn1 = BatchNorm(num_filters[0], dtype)
        inplanes = num_filters[0]
        stages = []
        for stage, planes in enumerate(num_filters[1:]):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(inplanes, planes, stride, dtype, g))
                inplanes = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.feat_dim = inplanes
        # SRRL / SimKD reuse the teacher classifier by this name
        self.classifier = TorchLinear(inplanes, num_classes, generator=g)

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


def _factory(depth, widths, block="basicblock"):
    def make(num_classes: int = 100, dtype=None, generator=None):
        return ResNetCifar(depth, widths, block, num_classes, dtype,
                           generator)

    return make


W1 = (16, 16, 32, 64)
W2 = (16, 32, 64, 128)
W4 = (32, 64, 128, 256)

resnet8 = _factory(8, W1)
resnet14 = _factory(14, W1)
resnet20 = _factory(20, W1)
resnet32 = _factory(32, W1)
resnet38 = _factory(38, W1)  # aka wrn_40_1
resnet44 = _factory(44, W1)
resnet56 = _factory(56, W1)
resnet110 = _factory(110, W1)
resnet116 = _factory(116, W1)
resnet200 = _factory(200, W1)
resnet14x2 = _factory(14, W2)  # aka wrn_16_2
resnet38x2 = _factory(38, W2)  # aka wrn_40_2
resnet110x2 = _factory(110, W2)
resnet8x4 = _factory(8, W4)
resnet14x4 = _factory(14, W4)  # aka wrn_16_4
resnet20x4 = _factory(20, W4)
resnet26x4 = _factory(26, W4)
resnet32x4 = _factory(32, W4)
resnet38x4 = _factory(38, W4)  # aka wrn_40_4
resnet44x4 = _factory(44, W4)
resnet56x4 = _factory(56, W4)
resnet110x4 = _factory(110, W4)
