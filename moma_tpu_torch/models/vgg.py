"""CIFAR VGG family with BatchNorm.

Counterpart of moma_tpu/models/vgg.py (`vgg8_bn` ... `vgg19_bn`): five
blocks of 3x3 convs (with a zero-initialized bias, padding 1 on both
sides), BN and relu; 2x2 max-pool after blocks 0-2, and after block 3 only
for 64^2 inputs (the reference quirk, vgg.py:70-73); a single `classifier`
Dense with the N(0, 0.01) init.  feats = (the five blocks' outputs,
pooled), NHWC; logits float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import (BatchNorm, Conv2d, Dense,
                                          default_generator, global_avg_pool)

CFGS = {
    "A": [[64], [128], [256, 256], [512, 512], [512, 512]],
    "B": [[64, 64], [128, 128], [256, 256], [512, 512], [512, 512]],
    "D": [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512],
          [512, 512, 512]],
    "E": [[64, 64], [128, 128], [256, 256, 256, 256],
          [512, 512, 512, 512], [512, 512, 512, 512]],
    "S": [[64], [128], [256], [512], [512]],
}


class VGG(nn.Module):
    def __init__(self, cfg_name: str, num_classes: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        cin = 3
        blocks = []
        for widths in CFGS[cfg_name]:
            layers = []
            for w in widths:
                layers += [Conv2d(cin, w, 3, padding=1, bias=True,
                                  dtype=dtype, generator=g),
                           BatchNorm(w, dtype), nn.ReLU()]
                cin = w
            blocks.append(nn.Sequential(*layers))
        self.blocks = nn.ModuleList(blocks)
        self.feat_dim = cin
        self.classifier = Dense(cin, num_classes, generator=g)

    def forward(self, x):
        h = x.shape[1]
        x = x.permute(0, 3, 1, 2)            # NHWC -> channels_last NCHW
        feats = []
        for b, block in enumerate(self.blocks):
            x = block(x)
            feats.append(x)
            if b < 3 or (b == 3 and h == 64):
                x = F.max_pool2d(x, 2, 2)
        pooled = global_avg_pool(x)
        logits = self.classifier(pooled.float())
        return tuple(f.permute(0, 2, 3, 1) for f in feats) + (pooled,), logits


def _factory(cfg_name):
    def make(num_classes: int = 100, dtype=None, generator=None):
        return VGG(cfg_name, num_classes, dtype, generator)

    return make


vgg8_bn = _factory("S")
vgg11_bn = _factory("A")
vgg13_bn = _factory("B")
vgg16_bn = _factory("D")
vgg19_bn = _factory("E")
