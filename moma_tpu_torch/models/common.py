"""Shared model building blocks: initializers, TorchLinear, Dense, the
conv (TF-SAME or explicitly padded), BatchNorm and the global pool.

Counterpart of moma_tpu/models/common.py.  Initializers match the JAX
package (which matches PyTorch's defaults):
  * conv:   kaiming-normal fan_out, std = sqrt(2 / (k*k*out_channels))
            (`conv_kernel_init`, common.py:32)
  * linear: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias
            (`TorchLinear`, common.py:35-69); `Dense`, flax nn.Dense with
            the N(0, 0.01) kernel and zero bias of vgg.py:33 and
            mobilenetv2.py:22
  * BN:     scale 1, bias 0; torch momentum 0.1 (flax 0.9), eps 1e-5
            (`BatchNorm`, common.py:72-104)
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

from moma_tpu_torch.ops.fused_bn import FusedBatchNorm


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


class Dense(TorchLinear):
    """flax nn.Dense with kernel N(0, 0.01) and a zero bias: the classifier
    init of the CIFAR VGG and MobileNetV2 (vgg.py:33-36,
    mobilenetv2.py:22-25)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features).normal_(
                0.0, 0.01, generator=default_generator(generator)))
        self.bias = nn.Parameter(torch.zeros(out_features))


def BatchNorm(num_features: int,
              dtype: Optional[torch.dtype] = None) -> FusedBatchNorm:
    """The backbone zoo's BatchNorm: FusedBatchNorm with torch conventions,
    flax momentum 0.9 and eps 1e-5 (common.py:72-104)."""
    return FusedBatchNorm(num_features, momentum=0.9, eps=1e-5, dtype=dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NC pooled embedding (common.py:107-109)."""
    return x.mean((2, 3))


class Conv2d(nn.Module):
    """flax nn.Conv on NCHW (channels_last) tensors: 'SAME' padding
    (conv2d_same) by default, or with an int `padding` flax's
    padding=p, ((p, p), (p, p)) on both sides, which is not SAME for a
    stride-2 3x3 conv on an even input.  `dtype` casts input and weight at
    use (None = promote the two, flax's default)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 padding: Optional[int] = None):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.kernel_size = kernel_size
        self.padding = padding
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
        if self.padding is not None:
            return F.conv2d(x, w, b, self.stride, self.padding, 1,
                            self.groups)
        return conv2d_same(x, w, b, self.stride, self.groups)


class ConvBN(nn.Module):
    """Conv2d with flax's symmetric padding (k - 1) // 2, then BatchNorm
    and an optional 'relu' / 'relu6' (the `_ConvBN` / `_CBR` /
    `_ConvBNReLU6` modules of moma_tpu's MobileNetV2 and ShuffleNet
    files); registered conv first, as flax calls them."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, act: Optional[str] = "relu",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, groups, dtype=dtype,
                           generator=generator, padding=(kernel - 1) // 2)
        self.bn = BatchNorm(cout, dtype)
        if act not in (None, "relu", "relu6"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        if self.act == "relu":
            return F.relu(x)
        if self.act == "relu6":
            # jnp.minimum(relu(x), 6)
            return x.clamp(0.0, 6.0)
        return x


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet's channel shuffle (shufflenet_v1.py:17-22) on an NCHW
    channels_last tensor, done on its NHWC bytes: one copy, and the result
    is channels_last again (the NCHW idiom view(N, g, C/g, H, W) would
    hand the next BatchNorm an NCHW-contiguous tensor to copy back)."""
    if groups == 1:
        return x
    N, C, H, W = x.shape
    y = x.permute(0, 2, 3, 1).reshape(N, H, W, groups, C // groups)
    return y.transpose(3, 4).reshape(N, H, W, C).permute(0, 3, 1, 2)


def concat_channels(xs, shuffle_groups: int = 1) -> torch.Tensor:
    """Concatenate NCHW channels_last tensors along the channels on their
    NHWC bytes, the result channels_last; with `shuffle_groups` equal to
    the number of inputs of one width, concat then channel_shuffle in the
    same single copy (interleaving the inputs' channels)."""
    nhwc = [t.permute(0, 2, 3, 1) for t in xs]
    if shuffle_groups == 1:
        y = torch.cat(nhwc, dim=-1)
    else:
        if len(xs) != shuffle_groups:
            raise ValueError("a fused concat + shuffle needs one input per "
                             "shuffle group")
        y = torch.stack(nhwc, dim=-1).flatten(-2)
    return y.permute(0, 3, 1, 2)
