"""ImageNet MobileNetV2 (torchvision layout, relu6).

Counterpart of moma_tpu/models/mobilenetv2_imagenet.py (`mobilenet_v2`):
stem 3x3 stride 2, 17 inverted-residual blocks (no 1x1 expand where the
ratio is 1), 1x1 head conv to 1280, pool, `classifier`.  feats = (stem,
the outputs of blocks 3, 6, 13 and 17, pooled), NHWC — the reference's
taps, which leave the head conv's output out (:87-99); logits float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from moma_tpu_torch.models.common import (ConvBN, TorchLinear,
                                          default_generator, global_avg_pool)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(act="relu6", dtype=dtype, generator=generator)
        hidden = int(round(inp * expand_ratio))
        layers = [ConvBN(inp, hidden, 1, **kw)] if expand_ratio != 1 else []
        layers += [ConvBN(hidden, hidden, 3, stride, groups=hidden, **kw),
                   ConvBN(hidden, oup, 1, **{**kw, "act": None})]
        self.conv = nn.Sequential(*layers)
        self.skip = stride == 1 and inp == oup

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.skip else y


_SETTING = [
    # t, c, n, s (torchvision)
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
_TAPS_AFTER = (3, 6, 13, 17)   # 1-based block indices


def _make_divisible(ch: float) -> int:
    """torchvision _make_divisible(ch, 8)."""
    v = max(8, int(ch + 4) // 8 * 8)
    return v + 8 if v < 0.9 * ch else v


class MobileNetV2ImageNet(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        kw = dict(act="relu6", dtype=dtype, generator=g)

        def c(ch):
            return _make_divisible(ch * width_mult)

        cin = c(32)
        self.stem = ConvBN(3, cin, 3, 2, **kw)
        blocks = []
        for t, ch, n, s in _SETTING:
            for i in range(n):
                blocks.append(InvertedResidual(cin, c(ch), s if i == 0 else 1,
                                               t, dtype, g))
                cin = c(ch)
        self.blocks = nn.ModuleList(blocks)
        last = c(1280) if width_mult > 1.0 else 1280
        self.head = ConvBN(cin, last, 1, **kw)
        self.feat_dim = last
        self.classifier = TorchLinear(last, num_classes, generator=g)

    def forward(self, x):
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> channels_last NCHW
        feats = [x]
        for i, block in enumerate(self.blocks, start=1):
            x = block(x)
            if i in _TAPS_AFTER:
                feats.append(x)
        pooled = global_avg_pool(self.head(x))
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def mobilenet_v2(num_classes: int = 1000, dtype=None, generator=None):
    return MobileNetV2ImageNet(num_classes, dtype=dtype, generator=generator)
