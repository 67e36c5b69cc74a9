"""Train-mode BatchNorm over hand-written CUDA channel reductions.

Counterpart of moma_tpu/ops/fused_bn.py.  Its two Pallas kernels become
CUDA kernels in csrc/bn_sums.cu:

  channel_sums       <- _sums_kernel      (fused_bn.py:149-159, via
                        channel_sums :254-269): per-channel f32 sum x, sum x^2
  grad_channel_sums  <- _grad_sums_kernel (fused_bn.py:162-173, via
                        grad_channel_sums :272-287): sum dy, sum dy*(x-mean)

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it.  There is no fall back
from one to the other.

`FusedBNTrain` replaces the custom VJP `fused_bn_train` (:314-358) and
`FusedBatchNorm` the flax module (:373-429), with flax numerics: f32
statistics, variance max(0, E[x^2] - E[x]^2), the BIASED batch variance in
the running update ra = m*ra + (1-m)*batch (torch.nn.BatchNorm2d uses the
unbiased one), and flax's normalize order.  Parameter and buffer names are
weight / bias / running_mean / running_var, so the JAX<->torch converter
(models/torch_import.py) sees it as a 'bn' module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from moma_tpu_torch.ops import _build
from moma_tpu_torch.runtime import count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_sums")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.moma_channel_sums.argtypes = [p, i32, i64, i32, i32, p, p, p, p, p]
    lib.moma_channel_sums.restype = i32
    lib.moma_channel_sums_chunks.argtypes = [p, i32, i64, i32, p]
    lib.moma_channel_sums_chunks.restype = i32
    lib.moma_grad_channel_sums.argtypes = [
        p, p, i32, p, i64, i32, i32, p, p, p, p, p]
    lib.moma_grad_channel_sums.restype = i32
    lib.moma_grad_sums_chunks.argtypes = [p, p, i32, i64, i32, p]
    lib.moma_grad_sums_chunks.restype = i32
    return lib


def _check_cuda_input(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype} not in (float32, "
                            "bfloat16)")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} / {x.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name}: shapes differ {tuple(t.shape)} / "
                             f"{tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(
                f"{name}: input must be contiguous with channels last "
                f"(an NHWC tensor or a channels_last NCHW tensor permuted to "
                f"NHWC); got strides {t.stride()}")
    if x.ndim < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")


def _chunks(lib: ctypes.CDLL, fn, name: str, *args) -> int:
    """The chunks of rows (grid.y) the first pass of a reduction takes for
    these tensors, as csrc/bn_sums.cu picks them from the card's occupancy:
    the rows of partial sums the wrapper allocates."""
    G = ctypes.c_int()
    _build.check(lib, fn(*args, ctypes.byref(G)), name)
    return G.value


# --------------------------------------------------------------- plain

def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum(x) and sum(x*x) over all axes but the last, in f32."""
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    return xf.sum(dims), (xf * xf).sum(dims)


def grad_channel_sums_plain(dy: torch.Tensor, x: torch.Tensor,
                            mean: torch.Tensor):
    """sum(dy) and sum(dy * (x - mean)) over all axes but the last (f32)."""
    dyf = dy.float()
    xm = x.float() - mean
    dims = tuple(range(x.ndim - 1))
    return dyf.sum(dims), (dyf * xm).sum(dims)


# --------------------------------------------------------------- wrappers

def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum(x) and sum(x*x) over all axes but the last, in f32.  x: (..., C)
    contiguous, float32 or bfloat16."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    _check_cuda_input("channel_sums", x)
    C = x.shape[-1]
    R = x.numel() // C
    lib = _lib()
    G = _chunks(lib, lib.moma_channel_sums_chunks, "channel_sums",
                x.data_ptr(), _DTYPE_CODES[x.dtype], R, C)
    part = torch.empty((2, G, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    rc = lib.moma_channel_sums(
        x.data_ptr(), _DTYPE_CODES[x.dtype], R, C, G,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "channel_sums")
    count_launch("channel_sums")
    return out[0], out[1]


def grad_channel_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor):
    """sum(dy) and sum(dy * (x - mean)) over all axes but the last (f32).
    dy, x: (..., C) contiguous, same dtype; mean: (C,) float32."""
    if x.device.type == "cpu":
        return grad_channel_sums_plain(dy, x, mean)
    _check_cuda_input("grad_channel_sums", dy, x)
    C = x.shape[-1]
    if (mean.device != x.device or mean.dtype != torch.float32
            or tuple(mean.shape) != (C,) or not mean.is_contiguous()):
        raise ValueError("grad_channel_sums: mean must be a contiguous "
                         f"float32 ({C},) tensor on {x.device}")
    R = x.numel() // C
    lib = _lib()
    G = _chunks(lib, lib.moma_grad_sums_chunks, "grad_channel_sums",
                dy.data_ptr(), x.data_ptr(), _DTYPE_CODES[x.dtype], R, C)
    part = torch.empty((2, G, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    rc = lib.moma_grad_channel_sums(
        dy.data_ptr(), x.data_ptr(), _DTYPE_CODES[x.dtype], mean.data_ptr(),
        R, C, G, part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "grad_channel_sums")
    count_launch("grad_channel_sums")
    return out[0], out[1]


def channel_stats(x: torch.Tensor):
    """(mean, var) over all axes but the last — flax numerics (f32, fast
    variance clipped at 0); fused_bn.py:290-298."""
    n = x.numel() // x.shape[-1]
    s, q = channel_sums(x)
    mean = s / n
    var = torch.clamp(q / n - mean * mean, min=0.0)
    return mean, var


# --------------------------------------------------------------- autograd

def _normalize(x, mean, var, scale, bias, eps: float, out_dtype):
    """flax `_normalize` op order: y = (x - mean) * (rsqrt(var+eps)*scale)
    + bias in f32, cast to out_dtype (fused_bn.py:305-311)."""
    y = x.float() - mean
    mul = torch.rsqrt(var + eps) * scale.float()
    return (y * mul + bias.float()).to(out_dtype)


class FusedBNTrain(torch.autograd.Function):
    """Train-mode batch norm over the last (channel) axis of a contiguous
    (..., C) tensor; returns (y, mean, var).  mean/var are the f32 batch
    statistics for the running update and carry no gradient
    (fused_bn.py:314-358)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, out_dtype):
        mean, var = channel_stats(x)
        invstd = torch.rsqrt(var + eps)
        y = _normalize(x, mean, var, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        x, scale, mean, invstd = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        # autograd may hand the cotangent in another layout; the kernel
        # reads (R, C) rows, so bring it to x's (a no-op when it matches)
        dy = dy.contiguous()
        sum_dy, sum_dy_xm = grad_channel_sums(dy, x, mean)
        g = scale.float() * invstd
        dscale = (sum_dy_xm * invstd).to(scale.dtype)
        dbias = sum_dy.to(scale.dtype)
        t1 = sum_dy / n
        t2 = (sum_dy_xm / n) * (invstd * invstd)
        dx = g * (dy.float() - t1 - (x.float() - mean) * t2)
        return dx.to(x.dtype), dscale, dbias, None, None


def fused_bn_train(x, scale, bias, eps: float, out_dtype):
    return FusedBNTrain.apply(x, scale, bias, eps, out_dtype)


class FusedBatchNorm(nn.Module):
    """BatchNorm with flax nn.BatchNorm numerics (see module docstring).

    Takes an (N, C, H, W) tensor, expected in torch.channels_last memory
    format so that its (N*H*W, C) view is contiguous, or an (N, C) tensor.
    `momentum` is flax's (0.99 = keep 99% of the running value); `dtype`
    is the output dtype (None = promote the input with float32, flax's
    `_canonical_out_dtype`).  Train vs eval follows module.train()/eval().
    """

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            xc = x.contiguous(memory_format=torch.channels_last)
            xc = xc.permute(0, 2, 3, 1)
        elif x.ndim == 2:
            xc = x.contiguous()
        else:
            raise ValueError(f"FusedBatchNorm takes 2-D or 4-D input, got "
                             f"{tuple(x.shape)}")
        out_dtype = (self.dtype if self.dtype is not None
                     else torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = _normalize(xc, self.running_mean, self.running_var,
                           self.weight, self.bias, self.eps, out_dtype)
        else:
            y, mean, var = FusedBNTrain.apply(
                xc, self.weight, self.bias, self.eps, out_dtype)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        return y.permute(0, 3, 1, 2) if x.ndim == 4 else y
