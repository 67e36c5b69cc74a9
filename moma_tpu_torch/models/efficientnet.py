"""EfficientNet B0-B7 — the reference's workhorse backbone.

Counterpart of moma_tpu/models/efficientnet.py: stem s2 -> 16 MBConv blocks
(expand 1x1, depthwise TF-SAME, squeeze-excite on the INPUT filter count
with bias, project 1x1, drop-connect + skip) -> 1x1 head -> pool ->
Dropout + Linear; BN momentum 0.99 / eps 1e-3; the feature contract
`(reductions..., head map, pooled)` — six entries for b0 at 64^2..512^2.

Layout: the public forward takes NHWC images and returns NHWC feature maps,
like moma_tpu.  Inside, every conv runs on an NCHW tensor in
torch.channels_last memory format (a free permute of NHWC), so each BN
input is a contiguous (N*H*W, C) view for the reduction kernel.

Modules are registered in flax call order (conv / bn / linear streams), so
moma_tpu_torch.models.torch_import aligns the two parameter trees
(see moma_tpu_torch.interop).

Dropout and drop-connect need a generator: the MoMA step passes none (the
JAX step passes no 'dropout' rng either), which makes them off and the
forward deterministic.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import Conv2d, TorchLinear, default_generator
from moma_tpu_torch.ops.fused_bn import FusedBatchNorm


class BlockArgs(NamedTuple):
    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float


B0_BLOCKS = (
    BlockArgs(1, 3, 1, 1, 32, 16, 0.25),
    BlockArgs(2, 3, 2, 6, 16, 24, 0.25),
    BlockArgs(2, 5, 2, 6, 24, 40, 0.25),
    BlockArgs(3, 3, 2, 6, 40, 80, 0.25),
    BlockArgs(3, 5, 1, 6, 80, 112, 0.25),
    BlockArgs(4, 5, 2, 6, 112, 192, 0.25),
    BlockArgs(1, 3, 1, 6, 192, 320, 0.25),
)

# (width_coeff, depth_coeff, resolution, dropout)
COEFFS = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    if width == 1.0:
        return filters
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def drop_connect(x: torch.Tensor, generator: torch.Generator,
                 rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (efficientnet.py:85-89)."""
    keep = 1.0 - rate
    mask = (torch.rand(x.shape[0], generator=generator) < keep).to(x.device)
    return x / keep * mask.to(x.dtype)[:, None, None, None]


def _bn(c: int, dtype) -> FusedBatchNorm:
    return FusedBatchNorm(c, momentum=BN_MOMENTUM, eps=BN_EPS, dtype=dtype)


class MBConvBlock(nn.Module):
    def __init__(self, in_filters: int, out_filters: int, kernel_size: int,
                 stride: int, expand_ratio: int, se_ratio: float,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.skip = stride == 1 and in_filters == out_filters
        expanded = in_filters * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand_conv = Conv2d(in_filters, expanded, 1, dtype=dtype,
                                      generator=g)
            self.bn0 = _bn(expanded, dtype)
        self.dw_conv = Conv2d(expanded, expanded, kernel_size, stride,
                              groups=expanded, dtype=dtype, generator=g)
        self.bn1 = _bn(expanded, dtype)
        self.has_se = se_ratio > 0
        if self.has_se:
            squeezed = max(1, int(in_filters * se_ratio))
            self.se_reduce = Conv2d(expanded, squeezed, 1, bias=True,
                                    dtype=dtype, generator=g)
            self.se_expand = Conv2d(squeezed, expanded, 1, bias=True,
                                    dtype=dtype, generator=g)
        self.project_conv = Conv2d(expanded, out_filters, 1, dtype=dtype,
                                   generator=g)
        self.bn2 = _bn(out_filters, dtype)

    def forward(self, x: torch.Tensor, drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inp = x
        if self.has_expand:
            x = F.silu(self.bn0(self.expand_conv(x)))
        x = F.silu(self.bn1(self.dw_conv(x)))
        if self.has_se:
            s = x.mean((2, 3), keepdim=True)
            s = self.se_expand(F.silu(self.se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self.bn2(self.project_conv(x))
        if self.skip:
            if self.training and drop_rate > 0 and generator is not None:
                x = drop_connect(x, generator, drop_rate)
            x = x + inp
        return x


class EfficientNet(nn.Module):
    """forward(NHWC images) -> (feats, logits); feats = (reductions...,
    head map, pooled embedding), maps NHWC (efficientnet.py:236-331)."""

    def __init__(self, variant: str = "b0", num_classes: int = 1000,
                 drop_connect_rate: float = 0.2,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        width, depth, _res, self.dropout = COEFFS[variant]
        self.drop_connect_rate = drop_connect_rate
        stem_ch = round_filters(32, width)
        self.stem_conv = Conv2d(3, stem_ch, 3, 2, dtype=dtype, generator=g)
        self.bn0 = _bn(stem_ch, dtype)
        blocks = []
        for ba in B0_BLOCKS:
            in_f = round_filters(ba.input_filters, width)
            out_f = round_filters(ba.output_filters, width)
            for r in range(round_repeats(ba.num_repeat, depth)):
                blocks.append(MBConvBlock(
                    in_f if r == 0 else out_f, out_f, ba.kernel_size,
                    ba.stride if r == 0 else 1, ba.expand_ratio, ba.se_ratio,
                    dtype=dtype, generator=g))
        self.blocks = nn.ModuleList(blocks)
        head_ch = round_filters(1280, width)
        self.head_conv = Conv2d(blocks[-1].project_conv.weight.shape[0],
                                head_ch, 1, dtype=dtype, generator=g)
        self.bn1 = _bn(head_ch, dtype)
        self.classifier = TorchLinear(head_ch, num_classes, generator=g)
        self.feat_dim = head_ch

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2)            # NHWC -> channels_last NCHW
        x = F.silu(self.bn0(self.stem_conv(x)))
        endpoints = []
        prev = x
        total = len(self.blocks)
        for idx, blk in enumerate(self.blocks):
            x = blk(x, self.drop_connect_rate * idx / total, generator)
            if prev.shape[2] > x.shape[2]:
                endpoints.append(prev)
            prev = x
        x = F.silu(self.bn1(self.head_conv(x)))
        endpoints.append(x)
        pooled = x.mean((2, 3))
        endpoints.append(pooled)
        z = pooled.float()
        if self.training and self.dropout > 0 and generator is not None:
            keep = 1.0 - self.dropout
            mask = (torch.rand(z.shape, generator=generator) < keep)
            z = z * mask.to(z.device, z.dtype) / keep
        logits = self.classifier(z)
        feats = tuple(e.permute(0, 2, 3, 1) if e.ndim == 4 else e
                      for e in endpoints)
        return feats, logits
