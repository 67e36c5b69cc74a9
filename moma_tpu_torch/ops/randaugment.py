"""One RandAugment layer — hand-written CUDA kernel + plain PyTorch version.

Counterpart of moma_tpu/ops/pallas_randaugment.py.  The Pallas kernel
`_make_kernel` (:214-349) becomes csrc/randaugment.cu; `layer_scalars`
(:352-399) is shared by the kernel and its plain version as O(B) torch
math; `ra_layer_from_draws` (:402-439) and `ra_layer_random` (the
`ra_layer_pallas` entry, :442-465) keep their roles.

Per image, driven by a 24-float scalar vector (slot layout in the JAX
module's docstring): a gate-off image is copied or flipped; a gated one
goes clip(round(x)) -> hflip -> one op -> enhance -> sharpness -> up to
three shear/translate passes -> clip(round()).  Exactly one op is active
per image, so for most images most stages are identities.

`ra_layer` launches the CUDA kernel for a CUDA tensor (or raises) and runs
`ra_layer_plain` for a CPU tensor.  The kernel is two launches a layer (a
statistics pass over the images whose op needs one, then one pass that
reads each image once and writes it once) after one memset of its
statistics scratch; the wrapper counts `ra_layer` once a call and the
kernel launches the call made under `ra_layer_kernels`.
`ra_layer_from_draws` builds the scalar vector on the draws' device (the
host, on the training path) and moves it to the card in one copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from moma_tpu_torch.data import randaugment as RA
from moma_tpu_torch.ops import _build
from moma_tpu_torch.runtime import count_launch

N_SCALARS = 24
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LUMA_R, LUMA_G, LUMA_B = 0.299, 0.587, 0.114


def layer_scalars(op, mag, sign, apply, H: int, fill: Sequence[float],
                  W: Optional[int] = None, hflip=None) -> torch.Tensor:
    """(B, 24) float32 per-image scalar vector from the sampled (op, mag,
    sign, apply[, hflip]) — pallas_randaugment.py:352-399."""
    B = op.shape[0]
    dev = mag.device
    mag = mag.float()
    f = RA._enhance_factor(mag)
    a = torch.where((op == 7) | (op == 8) | (op == 9), f, 1.0)
    b = torch.where(op == 7, 1.0 - f, 0.0)
    c_mean = torch.where(op == 8, 1.0 - f, 0.0)
    sharp_f = torch.where(op == 10, f, 1.0)

    m = RA._affine_matrix(op, mag, sign, H)
    ma, mb, mc, md, me, mf = (m[:, i] for i in range(6))
    is_rot = (mb.abs() > 1e-12) & (md.abs() > 1e-12)
    sin_psi = md
    tan_half = sin_psi / (1.0 + torch.clamp(ma, min=1e-6))
    cy = (H - 1) / 2.0
    cx = cy if W is None else (W - 1) / 2.0
    zero = torch.zeros_like(mag)
    p1_slope = torch.where(is_rot, -tan_half, mb)
    p1_center = torch.where(is_rot, cy, zero)
    p1_offset = torch.where(is_rot, zero, mc)
    p2_slope = torch.where(is_rot, sin_psi, md)
    p2_center = torch.where(is_rot, cx, zero)
    p2_offset = torch.where(is_rot, zero, mf)
    p3_slope = torch.where(is_rot, -tan_half, zero)

    bits_to_keep = torch.floor(mag / RA.MAX_LEVEL * 4)
    post_scale = torch.round(torch.exp2(8.0 - bits_to_keep))  # 2^dropped
    solar_th = torch.floor(mag / RA.MAX_LEVEL * 256)
    sadd_add = torch.floor(mag / RA.MAX_LEVEL * 110)

    fill_v = [float(v) for v in fill]
    cols = [a, b, c_mean, sharp_f,
            p1_slope, p1_center, p1_offset,
            p2_slope, p2_center, p2_offset, p3_slope,
            apply.float(),
            torch.full((B,), fill_v[0], device=dev),
            torch.full((B,), fill_v[1], device=dev),
            torch.full((B,), fill_v[2], device=dev),
            op.float(), post_scale, solar_th, sadd_add,
            zero if hflip is None else hflip.float()]
    cols += [zero] * (N_SCALARS - len(cols))
    return torch.stack(cols, dim=1).float().contiguous()


# --------------------------------------------------------------- plain

def _div(v: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor (or dividend) as a 0-dim tensor on `like`'s device.
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, and a Python scalar divided by a tensor is the tensor's
    reciprocal times the scalar on every device; either can differ from a
    true division in the last bit and flip a later floor() or round().  The
    kernel (and the TPU kernel) divide."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _equalize_plain(y: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize per channel of integer-valued (B,3,H,W) f32
    (pallas_randaugment.py::_equalize_image)."""
    B, C, H, W = y.shape
    v = y.long().reshape(B * C, H * W)
    hist = torch.zeros(B * C, 256, dtype=torch.int64, device=y.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    iota = torch.arange(256, device=y.device, dtype=torch.float32)[None, :]
    histf = hist.float()
    last_idx = torch.where(hist > 0, iota, -1.0).amax(1, keepdim=True)
    last_count = torch.where(iota == last_idx, histf, 0.0).sum(1, keepdim=True)
    step = torch.floor((float(H * W) - last_count) / _div(255.0, y))
    cum_before = (torch.cumsum(hist, 1) - hist).float()
    lut = torch.floor((cum_before + torch.floor(step / 2.0))
                      / torch.clamp(step, min=1.0))
    lut = torch.clamp(lut, 0.0, 255.0)
    lut = torch.where(step > 0.0, lut, iota)
    return torch.gather(lut, 1, v).reshape(B, C, H, W)


def _resample_pass_plain(y, slope, center, offset, along_w: bool, fill):
    """One shear/translate pass on (B,3,H,W): src = i + slope*(r-center)
    + offset with r the row (along W) or column (along H) index; linear
    interpolation, out-of-range taps take the fill colour
    (pallas_randaugment.py::_resample_pass)."""
    B, C, H, W = y.shape
    dev = y.device
    if along_w:
        r = torch.arange(H, device=dev, dtype=torch.float32)
        pos = torch.arange(W, device=dev, dtype=torch.float32)
        L = W
    else:
        r = torch.arange(W, device=dev, dtype=torch.float32)
        pos = torch.arange(H, device=dev, dtype=torch.float32)
        L = H
    shift = slope[:, None] * (r[None, :] - center[:, None]) + offset[:, None]
    k = torch.floor(shift)
    frac = shift - k                                     # (B, R)
    src0 = pos[None, None, :] + k[:, :, None]            # (B, R, L)
    src1 = src0 + 1.0
    v0 = (src0 >= 0) & (src0 <= L - 1)
    v1 = (src1 >= 0) & (src1 <= L - 1)
    i0 = torch.clamp(src0, 0, L - 1).long()
    i1 = torch.clamp(src1, 0, L - 1).long()
    if along_w:   # (B, H, W) index along dim 3
        g0 = torch.gather(y, 3, i0[:, None].expand(B, C, H, W))
        g1 = torch.gather(y, 3, i1[:, None].expand(B, C, H, W))
        v0, v1 = v0[:, None], v1[:, None]
        frac = frac[:, None, :, None]
    else:         # (B, W, H) -> index along dim 2
        i0 = i0.transpose(1, 2)
        i1 = i1.transpose(1, 2)
        g0 = torch.gather(y, 2, i0[:, None].expand(B, C, H, W))
        g1 = torch.gather(y, 2, i1[:, None].expand(B, C, H, W))
        v0, v1 = v0.transpose(1, 2)[:, None], v1.transpose(1, 2)[:, None]
        frac = frac[:, None, None, :]
    return (torch.where(v0, g0, fill) * (1.0 - frac)
            + torch.where(v1, g1, fill) * frac)


def ra_layer_plain(x: torch.Tensor, scalars: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The layer in plain PyTorch on any device: same per-stage math and
    rounding points as the CUDA kernel (and the TPU kernel it replaces)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    B, C, H, W = x.shape
    sc = scalars.float()

    def col(j):
        return sc[:, j].reshape(B, 1, 1, 1)

    gate = col(11) > 0.5
    flip = col(19) > 0.5
    op = col(15)
    xf = x.float()
    xin = torch.where(flip, xf.flip(3), xf)

    y = torch.clamp(torch.round(xin), 0.0, 255.0)
    y = torch.where(op == 2.0, 255.0 - y, y)
    ps = col(16)
    y = torch.where(op == 4.0, torch.floor(y / ps) * ps, y)
    y = torch.where(op == 5.0, torch.where(y < col(17), y, 255.0 - y), y)
    y = torch.where(
        op == 6.0,
        torch.where(y < 128.0, torch.clamp(y + col(18), max=255.0), y), y)
    lo = y.amin((2, 3), keepdim=True)
    hi = y.amax((2, 3), keepdim=True)
    scale = _div(255.0, y) / torch.clamp(hi - lo, min=1e-9)
    stretched = torch.floor(torch.clamp((y - lo) * scale, 0.0, 255.0))
    y = torch.where(op == 0.0, torch.where(hi > lo, stretched, y), y)
    y = torch.where(op == 1.0, _equalize_plain(y), y)

    a, bb, cm = col(0), col(1), col(2)
    enh = (a != 1.0) | (bb != 0.0) | (cm != 0.0)
    luma = torch.floor(LUMA_R * y[:, 0:1] + LUMA_G * y[:, 1:2]
                       + LUMA_B * y[:, 2:3] + 0.5)
    # exact integer sum, rounded once to f32 (the kernel's uint64 sum)
    luma_sum = luma.double().sum((2, 3), keepdim=True).float()
    mean_l = torch.floor(luma_sum / _div(float(H * W), y) + 0.5)
    y = torch.where(enh, a * y + bb * luma + cm * mean_l, y)

    f = col(3)
    p = F.pad(y, (1, 1, 1, 1))
    acc = 5.0 * y
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            acc = acc + p[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    sm = acc / _div(13.0, y)
    border = torch.zeros(H, W, dtype=torch.bool, device=x.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    sm = torch.where(border, y, sm)
    y = torch.where(f != 1.0, sm + f * (y - sm), y)

    fill = sc[:, 12:15].reshape(B, 3, 1, 1)
    cy = torch.full((B,), (H - 1) / 2.0, device=x.device)
    zero = torch.zeros(B, device=x.device)
    passes = (
        (sc[:, 4], sc[:, 5], sc[:, 6], True),
        (sc[:, 7], sc[:, 8], sc[:, 9], False),
        (sc[:, 10], cy, zero, True),
    )
    for slope, center, offset, along_w in passes:
        on = ((slope != 0.0) | (offset != 0.0)).reshape(B, 1, 1, 1)
        y = torch.where(
            on, _resample_pass_plain(y, slope, center, offset, along_w, fill),
            y)

    y = torch.round(torch.clamp(y, 0.0, 255.0))
    return torch.where(gate, y, xin).to(out_dtype)


# --------------------------------------------------------------- kernel

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("randaugment")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moma_ra_layer.argtypes = [p, p, i32, p, i32, i32, i32, p, p,
                                  ctypes.POINTER(i32)]
    lib.moma_ra_layer.restype = i32
    lib.moma_ra_scratch_bytes.argtypes = [i32]
    lib.moma_ra_scratch_bytes.restype = ctypes.c_size_t
    return lib


def scratch_bytes(B: int) -> int:
    """Bytes of device scratch one layer over B images takes: per image
    3x256 histogram bins, a luma sum, a ticket and a 3x256 LUT."""
    return int(_lib().moma_ra_scratch_bytes(B))


def _ra_layer_cuda(x: torch.Tensor, scalars: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES or out_dtype != x.dtype:
        raise TypeError(
            f"ra_layer: CUDA kernel takes float32 or bfloat16 and returns the "
            f"input dtype; got {x.dtype} -> {out_dtype}")
    if x.ndim != 4 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError("ra_layer: x must be a contiguous (B, 3, H, W) "
                         f"tensor, got {tuple(x.shape)} strides {x.stride()}")
    B, _, H, W = x.shape
    if 3 * H * W >= 2 ** 31 or B > 65535:
        raise ValueError(f"ra_layer: the kernel indexes an image in 32 bits "
                         f"and takes at most 65535 images; got {tuple(x.shape)}")
    if (scalars.device != x.device or scalars.dtype != torch.float32
            or tuple(scalars.shape) != (B, N_SCALARS)
            or not scalars.is_contiguous()):
        raise ValueError(f"ra_layer: scalars must be contiguous float32 "
                         f"({B}, {N_SCALARS}) on {x.device}")
    out = torch.empty_like(x)
    lib = _lib()
    scratch = torch.empty(scratch_bytes(B), dtype=torch.uint8, device=x.device)
    launched = ctypes.c_int(0)
    rc = lib.moma_ra_layer(
        x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
        scalars.data_ptr(), B, H, W, scratch.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
        ctypes.byref(launched))
    _build.check(lib, rc, "ra_layer")
    count_launch("ra_layer")
    count_launch("ra_layer_kernels", launched.value)
    return out


def ra_layer(x: torch.Tensor, scalars: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One RandAugment layer on (B,3,H,W) integer-valued images in
    [0,255] from their (B,24) scalar vectors: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return ra_layer_plain(x, scalars, out_dtype)
    return _ra_layer_cuda(x, scalars, out_dtype)


def ra_layer_from_draws(x: torch.Tensor, op, mag, sign, apply,
                        fill: Sequence[float],
                        out_dtype: torch.dtype = torch.float32,
                        hflip=None) -> torch.Tensor:
    """Layer entry with the per-image (op, mag, sign, apply[, hflip]) draws
    supplied by the caller (pallas_randaugment.py:402-439).  The (B, 24)
    scalar vector is built where the draws are (the host, for
    `ra_layer_random`) and reaches x's device in one copy."""
    B, C, H, W = x.shape
    dev = mag.device
    scalars = layer_scalars(op.to(dev), mag, sign.to(dev), apply.to(dev), H,
                            fill, W=W,
                            hflip=None if hflip is None else hflip.to(dev))
    if scalars.device != x.device:
        if x.device.type == "cuda":   # from pinned memory: no stream sync
            scalars = scalars.pin_memory().to(x.device, non_blocking=True)
        else:
            scalars = scalars.to(x.device)
    return ra_layer(x, scalars, out_dtype)


def ra_layer_random(x: torch.Tensor, generator: torch.Generator,
                    magnitude_mean: float, magnitude_std: float,
                    fill: Sequence[float], prob: float = 0.5,
                    out_dtype: torch.dtype = torch.float32, hflip=None,
                    op=None) -> torch.Tensor:
    """One layer with its draws taken from `generator` (a CPU generator:
    the O(B) draws are made on the host and moved to x's device) —
    pallas_randaugment.py::ra_layer_pallas :442-465.  op: optional
    externally drawn (B,) op indices."""
    B = x.shape[0]
    d = RA.draw_layer(B, generator, magnitude_mean, magnitude_std, prob)
    if op is not None:
        d["op"] = op
    return ra_layer_from_draws(x, d["op"], d["mag"], d["sign"], d["apply"],
                               fill, out_dtype=out_dtype, hflip=hflip)
