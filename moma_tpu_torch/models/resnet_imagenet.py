"""ImageNet ResNet / ResNeXt / wide-ResNet family.

Counterpart of moma_tpu/models/resnet_imagenet.py (torchvision layout):
7x7 stride-2 stem padded 3, BN, relu, 3x3 / 2 max-pool padded 1
(:100-104), four stages of Basic or Bottleneck blocks.  The wide
BasicBlock variants scale the stage widths by width_per_group / 64; the
Bottleneck's mid width is int(planes * width_per_group / 64) * groups, its
3x3 conv grouped (resnext50_32x4d).  feats = (after the max-pool, the four
stages' outputs, pooled), NHWC; logits float32 from `classifier`.
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
                 groups: int = 1, base_width: int = 64, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, **kw)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm(planes, dtype)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, **kw),
                BatchNorm(planes, dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, width, 1, **kw)
        self.bn1 = BatchNorm(width, dtype)
        self.conv2 = Conv2d(width, width, 3, stride, groups=groups,
                            padding=1, **kw)
        self.bn2 = BatchNorm(width, dtype)
        self.conv3 = Conv2d(width, out, 1, **kw)
        self.bn3 = BatchNorm(out, dtype)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, stride, **kw), BatchNorm(out, dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetImageNet(nn.Module):
    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 groups: int = 1, width_per_group: int = 64,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        # BasicBlock wide variants scale the stage widths (:95-99)
        multiplier = (width_per_group // 64
                      if block is BasicBlock and width_per_group != 64
                      else 1)
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, dtype=dtype, generator=g)
        self.bn1 = BatchNorm(64, dtype)
        inplanes = 64
        stages = []
        for stage, n in enumerate(layers):
            planes = int(64 * (2 ** stage) * multiplier)
            blocks = []
            for i in range(n):
                blocks.append(block(inplanes, planes,
                                    2 if stage > 0 and i == 0 else 1,
                                    groups, width_per_group, dtype, g))
                inplanes = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.feat_dim = inplanes
        self.classifier = TorchLinear(inplanes, num_classes, generator=g)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)            # NHWC -> channels_last NCHW
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = [x]
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        pooled = global_avg_pool(x)
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def _factory(block, layers, groups=1, width_per_group=64):
    def make(num_classes: int = 1000, dtype=None, generator=None):
        return ResNetImageNet(block, layers, num_classes, groups,
                              width_per_group, dtype, generator)

    return make


resnet18 = _factory(BasicBlock, (2, 2, 2, 2))
resnet34 = _factory(BasicBlock, (3, 4, 6, 3))
resnet50 = _factory(Bottleneck, (3, 4, 6, 3))
resnet101 = _factory(Bottleneck, (3, 4, 23, 3))
resnet152 = _factory(Bottleneck, (3, 8, 36, 3))
resnext50_32x4d = _factory(Bottleneck, (3, 4, 6, 3), groups=32,
                           width_per_group=4)
wide_resnet10_2 = _factory(BasicBlock, (1, 1, 1, 1), width_per_group=128)
wide_resnet18_2 = _factory(BasicBlock, (2, 2, 2, 2), width_per_group=128)
wide_resnet34_2 = _factory(BasicBlock, (3, 4, 6, 3), width_per_group=128)
wide_resnet50_2 = _factory(Bottleneck, (3, 4, 6, 3), width_per_group=128)
