"""CIFAR MobileNetV2.

Counterpart of moma_tpu/models/mobilenetv2.py (`mobile_half`,
`mobile_half_double`): stem 3x3 stride 2, seven inverted-residual stages
(1x1 expand, 3x3 depthwise through `groups`, 1x1 project; the skip where
the stride is 1 and the width is kept), 1x1 head conv, pool, a
`classifier` Dense with the N(0, 0.01) init.  feats = (stem, the outputs
of stages 1, 2, 4 and 6, pooled), NHWC (mobilenetv2.py:88-115); logits
float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from moma_tpu_torch.models.common import (ConvBN, Dense, default_generator,
                                          global_avg_pool)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        hidden = inp * expand_ratio
        self.expand = ConvBN(inp, hidden, 1, **kw)
        self.dw = ConvBN(hidden, hidden, 3, stride, groups=hidden, **kw)
        self.project = ConvBN(hidden, oup, 1, act=None, **kw)
        self.skip = stride == 1 and inp == oup

    def forward(self, x):
        y = self.project(self.dw(self.expand(x)))
        return x + y if self.skip else y


# (t, c, n, s) — mobilenetv2.py:70-78
_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 1),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
_TAPS = (1, 2, 4, 6)   # stages whose output is a feature (0-based)


class MobileNetV2Cifar(nn.Module):
    def __init__(self, num_classes: int = 100, width_mult: float = 0.5,
                 expand_T: int = 6, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        kw = dict(dtype=dtype, generator=g)
        w = width_mult
        cin = int(32 * w)
        self.stem = ConvBN(3, cin, 3, 2, **kw)
        stages = []
        for i, (t, c, n, s) in enumerate(_SETTING):
            t = t if i == 0 else expand_T
            blocks = []
            for j in range(n):
                blocks.append(InvertedResidual(cin, int(c * w),
                                               s if j == 0 else 1, t, **kw))
                cin = int(c * w)
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        last = int(1280 * w) if w > 1.0 else 1280
        self.head = ConvBN(cin, last, 1, **kw)
        self.feat_dim = last
        self.classifier = Dense(last, num_classes, generator=g)

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW
        feats = [x]
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i in _TAPS:
                feats.append(x)
        pooled = global_avg_pool(self.head(x))
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def mobile_half(num_classes: int = 100, dtype=None, generator=None):
    return MobileNetV2Cifar(num_classes, 0.5, dtype=dtype,
                            generator=generator)


def mobile_half_double(num_classes: int = 100, dtype=None, generator=None):
    return MobileNetV2Cifar(num_classes, 1.0, dtype=dtype,
                            generator=generator)
