"""Shared model building blocks: initializers, TorchLinear, TF-SAME conv.

Counterpart of moma_tpu/models/common.py.  Initializers match the JAX
package (which matches PyTorch's defaults):
  * conv:   kaiming-normal fan_out, std = sqrt(2 / (k*k*out_channels))
            (`conv_kernel_init`, common.py:32)
  * linear: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias
            (`TorchLinear`, common.py:35-69)
Every draw comes from an explicit torch.Generator.

Compute dtypes follow flax's `dtype=` rather than torch.autocast: the
parameters stay float32 and are cast at use, so both packages round at the
same points.  Convolutions take NCHW tensors in torch.channels_last memory
format (the physical NHWC layout of moma_tpu).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The given generator, or a fresh CPU one seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def conv_kernel_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """variance_scaling(2.0, 'fan_out', 'normal') on an (O, I/g, kh, kw)
    weight: fan_out = O * kh * kw, as flax computes it on HWIO."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def tf_same_pads(size: int, k: int, stride: int):
    """(lo, hi) padding of TF/flax 'SAME': out = ceil(size/stride)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b, stride: int,
                groups: int = 1) -> torch.Tensor:
    """F.conv2d with TF/flax 'SAME' padding.  TF-SAME pads (0, 1) for a
    stride-2 3x3 conv on an even input, which conv2d's symmetric `padding`
    cannot express: asymmetric pads go through F.pad first."""
    k = w.shape[-1]
    ph = tf_same_pads(x.shape[2], k, stride)
    pw = tf_same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride, (ph[0], pw[0]), 1, groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride, 0, 1, groups)


class TorchLinear(nn.Module):
    """Dense layer with torch-default init; the weight is cast to the
    input's dtype at use (common.py:50-69)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(
                -bound, bound, generator=g))
        self.bias = (nn.Parameter(torch.empty(out_features).uniform_(
            -bound, bound, generator=g)) if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype).t()
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Conv2d(nn.Module):
    """flax nn.Conv with 'SAME' padding (conv2d_same) on NCHW
    (channels_last) tensors.  `dtype` casts input and weight at use (None =
    promote the two, flax's default)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, kernel_size))
        conv_kernel_init_(self.weight, default_generator(generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = (self.dtype if self.dtype is not None
              else torch.promote_types(x.dtype, self.weight.dtype))
        x = x.to(dt)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d_same(x, w, b, self.stride, self.groups)
