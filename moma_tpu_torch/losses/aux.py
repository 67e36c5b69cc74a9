"""Trainable auxiliary modules of the KD loss zoo.

Counterpart of moma_tpu/losses/aux.py, as torch modules with its names:
`ConvReg` (:36), `Proj` (:81), `MLPEmbed` (:103), `SelfA` (:117),
`VIDRegressor` (:179), `SRRL` (:212), `SimKD` (:231), `Embed` (:269) and
`LinearEmbed` (:282).  The JAX modules infer their input widths at init;
here they are constructor arguments.

They take and return NHWC maps, as the port's backbones give them; inside,
each convolution runs on the channels_last NCHW view (a free permute).
Convolutions have flax's `dtype=` semantics (input and weight cast to
`dtype`, or promoted when it is None) and flax's initializers: ConvReg's
torch-default U(+-sqrt(1/fan_in)) with a zero bias, the others'
kaiming-normal fan_out without bias.  Their BatchNorms are the port's
`FusedBatchNorm` with the torch conventions of the JAX package's aux
`BatchNorm` (moma_tpu/models/common.py:72-95): eps 1e-5, torch momentum
0.1 (flax 0.9); in train mode they reduce through the `channel_sums` and
`grad_channel_sums` kernels.  Submodules are registered in flax call
order, so moma_tpu_torch.interop aligns the two parameter trees.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.losses.functional import (adaptive_avg_pool_nhwc,
                                              l2_normalize)
from moma_tpu_torch.models.common import (BatchNorm, TorchLinear,
                                          conv_kernel_init_,
                                          default_generator)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AuxConv(nn.Module):
    """flax nn.Conv (or, with `transpose`, nn.ConvTranspose with explicit
    padding) on NCHW channels_last tensors.  `torch_init`: the torch
    default U(+-sqrt(1/fan_in)) with a bias; else kaiming-normal fan_out
    without one.  The transposed conv is flax's: the input dilated by the
    stride, padded by `padding` and correlated with the unflipped kernel
    (jax.lax.conv_transpose with transpose_kernel=False)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: int = 0, torch_init: bool = False,
                 transpose: bool = False, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.stride, self.padding, self.transpose = stride, padding, transpose
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        if torch_init:
            bound = math.sqrt(1.0 / (cin * kernel[0] * kernel[1]))
            with torch.no_grad():
                self.weight.uniform_(-bound, bound, generator=g)
            self.bias = nn.Parameter(torch.zeros(cout))
        else:
            conv_kernel_init_(self.weight, g)
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = (self.dtype if self.dtype is not None
              else torch.promote_types(x.dtype, self.weight.dtype))
        x = x.to(dt)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.transpose:
            s = self.stride
            N, C, H, W = x.shape
            xd = x.new_zeros(N, C, (H - 1) * s + 1, (W - 1) * s + 1).to(
                memory_format=torch.channels_last)
            xd[:, :, ::s, ::s] = x
            return F.conv2d(xd, w, b, 1, self.padding)
        return F.conv2d(x, w, b, self.stride, self.padding)


class ConvReg(nn.Module):
    """FitNet shape adapter: regress the student's hint map onto the
    teacher's (H, W, C); returns (regressed student, matched teacher).
    s_shape / t_shape are (H, W, C)."""

    def __init__(self, s_shape: Sequence[int], t_shape: Sequence[int],
                 dtype=None, generator=None):
        super().__init__()
        s_H, s_W, s_C = s_shape
        t_H, t_W, t_C = t_shape
        self.pool_t = None
        kw = dict(torch_init=True, dtype=dtype, generator=generator)
        if s_H == 2 * t_H:
            self.conv = AuxConv(s_C, t_C, (3, 3), 2, 1, **kw)
        elif s_H * 2 == t_H:
            self.conv = AuxConv(s_C, t_C, (4, 4), 2, 1, transpose=True, **kw)
        elif s_H >= t_H:
            self.conv = AuxConv(s_C, t_C, (1 + s_H - t_H, 1 + s_W - t_W),
                                **kw)
        else:
            self.conv = AuxConv(s_C, t_C, (3, 3), 1, 1, **kw)
            self.pool_t = (s_H, s_W)
        self.bn = BatchNorm(t_C, dtype)

    def forward(self, x, t):
        y = F.relu(self.bn(self.conv(_nchw(x))))
        if self.pool_t is not None:
            t = adaptive_avg_pool_nhwc(t, *self.pool_t)
        return _nhwc(y), t


class Proj(nn.Module):
    """1x1 - 3x3 - 1x1 channel aligner with two BN-ReLUs."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None,
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        mid = 2 * out_channels
        self.conv1 = AuxConv(in_channels, mid, (1, 1), dtype=dtype,
                             generator=g)
        self.bn1 = BatchNorm(mid, dtype)
        self.conv2 = AuxConv(mid, mid, (3, 3), 1, 1, dtype=dtype, generator=g)
        self.bn2 = BatchNorm(mid, dtype)
        self.conv3 = AuxConv(mid, out_channels, (1, 1), dtype=dtype,
                             generator=g)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(_nchw(x))))
        y = F.relu(self.bn2(self.conv2(y)))
        return _nhwc(self.conv3(y))


class MLPEmbed(nn.Module):
    """linear - relu - linear - l2 norm."""

    def __init__(self, dim_in: int, dim_out: int, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.linear1 = TorchLinear(dim_in, 2 * dim_out, generator=g)
        self.linear2 = TorchLinear(2 * dim_out, dim_out, generator=g)

    def forward(self, x):
        x = F.relu(self.linear1(x.reshape(x.shape[0], -1)))
        return l2_normalize(self.linear2(x).float(), dim=1)


class SelfA(nn.Module):
    """SemCKD cross-layer attention over batch-similarity matrices (its
    embedding width is the batch size); returns (projected student values
    [i][j], teacher targets [i][j], attention (B, s_len, t_len))."""

    def __init__(self, s_channels: Sequence[int], t_channels: Sequence[int],
                 batch_size: int,
                 soft: float = 1.0, factor: int = 4, dtype=None,
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        self.batch_size, self.soft = batch_size, soft
        qdim = batch_size // factor
        self.query = nn.ModuleList(MLPEmbed(batch_size, qdim, g)
                                   for _ in s_channels)
        self.key = nn.ModuleList(MLPEmbed(batch_size, qdim, g)
                                 for _ in t_channels)
        self.regressor = nn.ModuleList(Proj(s_c, t_c, dtype, g)
                                       for s_c in s_channels
                                       for t_c in t_channels)

    def forward(self, feat_s, feat_t, ax):
        """`ax`: a core/mesh data axis.  In a group the batch-similarity
        matrices are the global batch's (the maps gathered from every
        rank, the student's with their gradient), as `batch_size` is, and
        the attention comes back for this rank's rows; the regressors run
        on this rank's rows only."""
        B = self.batch_size

        def sim(f):
            f = f.float().reshape(B, -1)
            return f @ f.T

        queries = torch.stack([q(sim(ax.gather_grad(f)))
                               for q, f in zip(self.query, feat_s)], 1)
        keys = torch.stack([k(sim(ax.gather(f)))
                            for k, f in zip(self.key, feat_t)], 2)
        attention = torch.softmax(
            torch.einsum("bsq,bqt->bst", queries, keys) / self.soft, -1)
        attention = ax.local_slice(attention, feat_s[0].shape[0])
        values, targets = [], []
        n_t = len(feat_t)
        for i, fs in enumerate(feat_s):
            values.append([])
            targets.append([])
            for j, ft in enumerate(feat_t):
                s_H, t_H = fs.shape[1], ft.shape[1]
                if s_H > t_H:
                    source, target = adaptive_avg_pool_nhwc(fs, t_H, t_H), ft
                else:
                    source, target = fs, adaptive_avg_pool_nhwc(ft, s_H, s_H)
                values[i].append(self.regressor[i * n_t + j](source))
                targets[i].append(target)
        return values, targets, attention


class VIDRegressor(nn.Module):
    """VID's 1x1 conv regressor and its per-channel `log_scale`; returns
    (predicted mean NHWC, log_scale)."""

    def __init__(self, in_channels: int, mid_channels: int,
                 target_channels: int, init_pred_var: float = 5.0,
                 eps: float = 1e-5, dtype=None, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.conv1 = AuxConv(in_channels, mid_channels, (1, 1), dtype=dtype,
                             generator=g)
        self.conv2 = AuxConv(mid_channels, mid_channels, (1, 1), dtype=dtype,
                             generator=g)
        self.conv3 = AuxConv(mid_channels, target_channels, (1, 1),
                             dtype=dtype, generator=g)
        self.log_scale = nn.Parameter(torch.full(
            (target_channels,),
            float(math.log(math.exp(init_pred_var - eps) - 1.0))))

    def forward(self, x):
        y = F.relu(self.conv1(_nchw(x)))
        y = F.relu(self.conv2(y))
        return _nhwc(self.conv3(y)), self.log_scale


class SRRL(nn.Module):
    """1x1 conv + BN + ReLU lifting the pooled student embedding into the
    teacher's feature space (the caller applies the teacher's
    classifier)."""

    def __init__(self, s_dim: int, t_dim: int, dtype=None, generator=None):
        super().__init__()
        self.conv = AuxConv(s_dim, t_dim, (1, 1), dtype=dtype,
                            generator=generator)
        self.bn = BatchNorm(t_dim, dtype)

    def forward(self, feat_s):
        y = F.relu(self.bn(self.conv(_nchw(feat_s[:, None, None, :]))))
        return y.reshape(y.shape[0], -1)


class SimKD(nn.Module):
    """Bottleneck onto the teacher's last map for the reused teacher
    classifier; returns (transferred student NHWC, matched teacher NHWC,
    pooled transferred student (B, C))."""

    def __init__(self, s_channels: int, t_channels: int, factor: int = 2,
                 dtype=None, generator=None):
        super().__init__()
        g = default_generator(generator)
        mid = t_channels // factor
        self.conv1 = AuxConv(s_channels, mid, (1, 1), dtype=dtype,
                             generator=g)
        self.bn1 = BatchNorm(mid, dtype)
        self.conv2 = AuxConv(mid, mid, (3, 3), 1, 1, dtype=dtype, generator=g)
        self.bn2 = BatchNorm(mid, dtype)
        self.conv3 = AuxConv(mid, t_channels, (1, 1), dtype=dtype,
                             generator=g)
        self.bn3 = BatchNorm(t_channels, dtype)

    def forward(self, feat_s, feat_t):
        s_H, t_H = feat_s.shape[1], feat_t.shape[1]
        if s_H > t_H:
            source, target = adaptive_avg_pool_nhwc(feat_s, t_H, t_H), feat_t
        else:
            source, target = feat_s, adaptive_avg_pool_nhwc(feat_t, s_H, s_H)
        y = F.relu(self.bn1(self.conv1(_nchw(source))))
        y = F.relu(self.bn2(self.conv2(y)))
        trans = _nhwc(F.relu(self.bn3(self.conv3(y))))
        return trans, target, trans.mean((1, 2))


class Embed(nn.Module):
    """Linear + L2 norm: the CRD projection head."""

    def __init__(self, dim_in: int, dim_out: int = 128, generator=None):
        super().__init__()
        self.linear = TorchLinear(dim_in, dim_out, generator=generator)

    def forward(self, x):
        return l2_normalize(self.linear(x.reshape(x.shape[0], -1)).float(),
                            dim=1)


class LinearEmbed(nn.Module):
    """Plain linear embedding: the CC loss head."""

    def __init__(self, dim_in: int, dim_out: int = 128, generator=None):
        super().__init__()
        self.linear = TorchLinear(dim_in, dim_out, generator=generator)

    def forward(self, x):
        return self.linear(x.reshape(x.shape[0], -1))
