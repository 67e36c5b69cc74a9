"""int8 convolutions with int32 sums and the int8 quantize of their input.

No Pallas kernel stands behind these: the JAX package runs them through
XLA (moma_tpu/core/quantize.py:213-228 the quantize, the int8 x int8 ->
int32 convolution and its f32 epilogue; :239-249 the dense; :283 the
dynamic scale), and PyTorch has no int8 convolution on CUDA that sums in
int32.  So the port has three hand-written kernels in csrc/int8_conv.cu:

  int8_quantize   q = clip(rint(x / s_x), -127, 127) as int8, with s_x
                  given (calibrated) or max(max|x|, 1e-6) / 127 of this
                  tensor (dynamic: a first pass for the absmax)
  int8_conv_gemm  an implicit-GEMM convolution for cin/groups > 1, on the
                  tensor cores; a dense layer is its 1x1 case
  int8_conv_dw    a direct depthwise convolution (cin/groups == 1)

each convolution ending in out = f32(acc) * (s_x * s_w[o]) (+ bias[o])
cast to the output dtype.  Each is a `torch.library.custom_op`
(`moma_tpu_torch::int8_quantize`, `moma_tpu_torch::int8_conv2d`) with a
fake implementation, so `torch.export` carries it into a serving artifact
(core/export.py): its CPU implementation is the plain version below, its
CUDA one launches the kernel or raises.  Launches count in
`runtime.launch_counts()` under int8_quantize, int8_conv_gemm and
int8_conv_dw.

The plain versions give the kernels' results bit for bit: the int32 sum is
an F.conv2d of the int8 values in float64, exact for every fan-in here
(|sum| <= 127^2 * K < 2^31 < 2^53), never an F.conv2d on int8 tensors (on
the CPU that returns int8 and wraps); divisions take a tensor divisor on
the operand's device (on CUDA PyTorch multiplies by the reciprocal of a
Python-number divisor); torch.round rounds half to even.

Layouts: 4-D tensors are NCHW in channels_last memory (the NHWC bytes the
kernels read); q_w is OIHW int8 as F.conv2d takes it (the CUDA
implementation lays it out for its kernel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from moma_tpu_torch.ops import _build
from moma_tpu_torch.runtime import count_launch

QMAX = 127.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 32   # the gemm kernel's K slice: the weight rows are padded to it


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.moma_int8_quantize.argtypes = [p, i32, i64, p, p, p, p, p]
    lib.moma_int8_quantize.restype = i32
    for fn in (lib.moma_int8_conv_gemm, lib.moma_int8_conv_dw):
        fn.argtypes = [p, p, p, p, p, p, i32, p, p]
        fn.restype = i32
    return lib


def _layout(x: Tensor) -> Tensor:
    """x with the kernels' memory layout: channels_last for 4-D (a no-op
    when it has it), contiguous otherwise."""
    if x.ndim == 4:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


def _qmax(t: Tensor) -> Tensor:
    return torch.full((), QMAX, dtype=torch.float32, device=t.device)


def _empty_out(shape, dtype: torch.dtype, device) -> Tensor:
    """A convolution's output: channels_last strides, the same on every
    route (the plain version, the kernel's, the fake one) for every shape,
    1x1 maps too."""
    return torch.empty(shape, dtype=dtype, device=device,
                       memory_format=torch.channels_last)


def conv_out_hw(H: int, W: int, kh: int, kw: int, stride, padding,
                dilation) -> Tuple[int, int]:
    """(Ho, Wo) of a convolution; padding = (top, bottom, left, right)."""
    Ho = (H + padding[0] + padding[1] - dilation[0] * (kh - 1) - 1) \
        // stride[0] + 1
    Wo = (W + padding[2] + padding[3] - dilation[1] * (kw - 1) - 1) \
        // stride[1] + 1
    return Ho, Wo


# --------------------------------------------------------------- plain

def quantize_plain(x: Tensor, scale: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """(q int8 in x's layout, the f32 scale used): scale = max(max|x|, 1e-6)
    / 127 when none is given (quantize.py:283), q = clip(round(x / scale),
    -127, 127) (:213-214)."""
    xf = _layout(x).float()
    if scale is None:
        scale = torch.div(xf.abs().amax().clamp_min(1e-6), _qmax(xf))
    q = torch.round(xf / scale).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale.to(torch.float32).clone()


def conv_plain(q_x: Tensor, q_w: Tensor, s_x: Tensor, s_w: Tensor,
               bias: Optional[Tensor], stride: List[int], padding: List[int],
               dilation: List[int], groups: int,
               out_dtype: torch.dtype) -> Tensor:
    """The int32 sum of an int8 convolution, exactly, in float64 (cuDNN off:
    none of its algorithms may transform the sum), then the f32 epilogue
    f32(acc) * (s_x * s_w) (+ bias) cast to out_dtype (quantize.py:225-228);
    channels_last."""
    with torch.backends.cudnn.flags(enabled=False):
        xp = F.pad(q_x.double(), (padding[2], padding[3], padding[0],
                                  padding[1]))
        acc = F.conv2d(xp, q_w.double(), None, stride, 0, dilation, groups)
    out = acc.float() * (s_x * s_w).view(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1)
    return _empty_out(out.shape, out_dtype, out.device).copy_(out)


# --------------------------------------------------------------- kernels

def _check_cuda(name: str, *ts: Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")


def _quantize_cuda(x: Tensor, scale: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor]:
    _check_cuda("int8_quantize", x, scale)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_quantize: dtype {x.dtype} not in (float32, "
                        "bfloat16)")
    if x.numel() == 0:
        raise ValueError(f"int8_quantize: empty input {tuple(x.shape)}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise ValueError("int8_quantize: the scale must be one float32")
    x = _layout(x)
    q = torch.empty_like(x, dtype=torch.int8)
    s_out = torch.empty((), dtype=torch.float32, device=x.device)
    amax = torch.empty((), dtype=torch.int32, device=x.device)
    lib = _lib()
    rc = lib.moma_int8_quantize(
        x.data_ptr(), _DTYPE_CODES[x.dtype], x.numel(),
        None if scale is None else scale.contiguous().data_ptr(),
        amax.data_ptr(), s_out.data_ptr(), q.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "int8_quantize")
    count_launch("int8_quantize")
    return q, s_out


def _conv_cuda(q_x: Tensor, q_w: Tensor, s_x: Tensor, s_w: Tensor,
               bias: Optional[Tensor], stride: List[int], padding: List[int],
               dilation: List[int], groups: int,
               out_dtype: torch.dtype) -> Tensor:
    _check_cuda("int8_conv2d", q_x, q_w, s_x, s_w, bias)
    if q_x.dtype != torch.int8 or q_w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d: operands {q_x.dtype}, {q_w.dtype}; "
                        "expected int8")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_conv2d: output dtype {out_dtype} not in "
                        "(float32, bfloat16)")
    N, Cin, H, W = q_x.shape
    Cout, Cg, kh, kw = q_w.shape
    if Cin != Cg * groups or Cout % groups:
        raise ValueError(f"int8_conv2d: {Cin} input channels, weight "
                         f"{tuple(q_w.shape)}, groups {groups}")
    Ho, Wo = conv_out_hw(H, W, kh, kw, stride, padding, dilation)
    q_x = _layout(q_x)
    out = _empty_out((N, Cout, Ho, Wo), out_dtype, q_x.device)
    sw = s_w.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    if Cg == 1:
        name, w = "int8_conv_dw", q_w.reshape(Cout, kh * kw).t().contiguous()
        Kp = 0
    else:
        K = kh * kw * Cg
        Kp = -(-K // _BK) * _BK
        name = "int8_conv_gemm"
        w = q_w.new_zeros((Cout, Kp))
        w[:, :K] = q_w.permute(0, 2, 3, 1).reshape(Cout, K)
    dims = (ctypes.c_int64 * 17)(
        N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride[0], stride[1], padding[0],
        padding[2], dilation[0], dilation[1], groups, Kp)
    lib = _lib()
    fn = lib.moma_int8_conv_dw if Cg == 1 else lib.moma_int8_conv_gemm
    rc = fn(q_x.data_ptr(), w.data_ptr(), s_x.float().contiguous().data_ptr(),
            sw.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), _DTYPE_CODES[out_dtype], dims,
            torch.cuda.current_stream(q_x.device).cuda_stream)
    _build.check(lib, rc, name)
    count_launch(name)
    return out


# --------------------------------------------------------------- the ops

@torch.library.custom_op("moma_tpu_torch::int8_quantize", mutates_args=(),
                         device_types="cpu")
def int8_quantize(x: Tensor, scale: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """(q int8, scale f32): x quantized with the given per-tensor scale, or
    with its own (dynamic) one.  4-D x in channels_last memory."""
    return quantize_plain(x, scale)


@int8_quantize.register_kernel("cuda")
def _(x, scale):
    return _quantize_cuda(x, scale)


@int8_quantize.register_fake
def _(x, scale):
    return (torch.empty_like(_layout(x), dtype=torch.int8),
            x.new_empty((), dtype=torch.float32))


@torch.library.custom_op("moma_tpu_torch::int8_conv2d", mutates_args=(),
                         device_types="cpu")
def int8_conv2d(q_x: Tensor, q_w: Tensor, s_x: Tensor, s_w: Tensor,
                bias: Optional[Tensor], stride: List[int],
                padding: List[int], dilation: List[int], groups: int,
                out_dtype: torch.dtype) -> Tensor:
    """f32(conv(q_x, q_w) in int32) * (s_x * s_w) (+ bias) as out_dtype;
    padding = (top, bottom, left, right); channels_last out."""
    return conv_plain(q_x, q_w, s_x, s_w, bias, stride, padding, dilation,
                      groups, out_dtype)


@int8_conv2d.register_kernel("cuda")
def _(q_x, q_w, s_x, s_w, bias, stride, padding, dilation, groups,
      out_dtype):
    return _conv_cuda(q_x, q_w, s_x, s_w, bias, stride, padding, dilation,
                      groups, out_dtype)


@int8_conv2d.register_fake
def _(q_x, q_w, s_x, s_w, bias, stride, padding, dilation, groups,
      out_dtype):
    N, _, H, W = q_x.shape
    Cout, _, kh, kw = q_w.shape
    Ho, Wo = conv_out_hw(H, W, kh, kw, stride, padding, dilation)
    return _empty_out((N, Cout, Ho, Wo), out_dtype, q_x.device)
