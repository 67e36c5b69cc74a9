"""Recompute-style fused EfficientNet forward for the gradient-free teacher.

Counterpart of moma_tpu/ops/fused_effnet.py and of the host side of
moma_tpu/ops/fused_effnet_pallas.py.  A module forward writes every MBConv
intermediate to device memory: the expanded tensor (6x the block input), its
normalized copy, the depthwise output, its normalized copy, the SE-scaled
copy.  This forward keeps the expanded tensor out of device memory
altogether and writes the depthwise output once; per MBConv block it runs

  K1 k1_expand_stats : sum, sum^2 per expanded channel of round(W_exp . y)
                       (BN1 batch statistics; train mode only)
  K2 k2_depthwise    : dwout = dw_{k,s}(silu(bn1(W_exp . y))), written once,
                       and its per-channel sum, sum^2 (BN2)
  SE (torch ops)     : the sigmoid MLP over the mean of silu(bn2(dwout))
  K4 k4_project      : tmp = W_proj . (se * silu(bn2(dwout))) and its
                       per-channel sum, sum^2 (BN3)
  finalize (torch)   : y' = bn3(tmp) [+ y]

The three Pallas kernels become CUDA kernels in csrc/fused_effnet.cu:

  k1_expand_stats <- _k1_kernel (fused_effnet_pallas.py:207-226, call :429)
  k2_depthwise    <- _k2_kernel (:229-253, call :448)
  k4_project      <- _k4_kernel (:256-285, call :481)

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it.  There is no fall back
from one to the other and no flag that chooses.

Layout.  The TPU kernels keep dense NCHW with W on the lanes, phase-split
stride-2 inputs and (C,1,2) affine planes, all of them answers to Mosaic.
Here tensors are what moma_tpu_torch.models.efficientnet uses: logical
(N, C, H, W) in torch.channels_last memory, i.e. physically (N, H, W, C), so
a 1x1 conv is a (pixels x C) . (C x E) product and depthwise taps read
neighbouring channels.  Every MBConv block goes through K1/K2/K4 whatever its
width (the JAX package sends a block to its kernels only from 128 columns
up, a limit of Mosaic's lowering; both of its branches compute the same
function).

Rounding points (cd = compute dtype) mirror the Pallas path, in the kernels
and in their plain versions alike: ex = cd(W_exp . y) with f32 accumulation
-> cd(f32(ex)*a + b) -> silu in f32 -> cd; depthwise taps are f32 weights
with f32 accumulation, then cd; h2 = silu(cd(f32(dw)*a + b)), scaled =
cd(f32(h2)*se), tmp = cd(W_proj . scaled); statistics are taken of the
rounded values in f32, var = max(0, E[x^2] - E[x]^2);
a = scale*rsqrt(var + eps), b = bias - mean*a.  Zero padding surrounds
silu(bn1(expand(y))), not y.  `reference_block` / `reference_forward` are the
plain NCHW mirror of moma_tpu's functions of the same names; in bf16 they
differ from the fused path by design in two places (they round the depthwise
taps to cd and pool SE from the cd-rounded activation).

`extract_params` returns views of the module's parameters and BN buffers, so
an in-place EMA on the module shows through, and `updated_batch_stats`
updates the module's running statistics in place through those views.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from moma_tpu_torch.models.common import conv2d_same, tf_same_pads
from moma_tpu_torch.models.efficientnet import (B0_BLOCKS, BN_EPS,
                                                BN_MOMENTUM, COEFFS,
                                                round_filters, round_repeats)
from moma_tpu_torch.ops import _build
from moma_tpu_torch.ops.fused_bn import channel_stats
from moma_tpu_torch.runtime import count_launch

Tensor = torch.Tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class BlockSpec(NamedTuple):
    in_filters: int
    out_filters: int
    expand: int          # expand ratio (1 = no expand conv / no bn1)
    kernel: int
    stride: int
    se: int              # squeezed channels
    has_skip: bool


def block_specs(variant: str = "b0") -> List[BlockSpec]:
    width, depth, _res, _drop = COEFFS[variant]
    specs = []
    for ba in B0_BLOCKS:
        inf = round_filters(ba.input_filters, width)
        outf = round_filters(ba.output_filters, width)
        for r in range(round_repeats(ba.num_repeat, depth)):
            in_f = inf if r == 0 else outf
            stride = ba.stride if r == 0 else 1
            specs.append(BlockSpec(
                in_filters=in_f, out_filters=outf, expand=ba.expand_ratio,
                kernel=ba.kernel_size, stride=stride,
                se=max(1, int(in_f * ba.se_ratio)),
                has_skip=(stride == 1 and in_f == outf)))
    return specs


# ------------------------------------------------------------ parameters

def _bn(bn) -> Dict[str, Tensor]:
    return {"scale": bn.weight.detach(), "bias": bn.bias.detach(),
            "mean": bn.running_mean, "var": bn.running_var}


def _w1x1(conv) -> Tensor:
    return conv.weight.detach()[:, :, 0, 0]          # (Cout, Cin) view


def extract_params(model, variant: str = "b0"):
    """Per-block views of an `EfficientNet` module's weights (no copies):
    1x1 conv weights as (Cout, Cin), depthwise as (C, k, k), SE convs with
    bias, BN as {scale, bias, mean, var} with mean/var the running buffers.
    Returns (params, specs)."""
    specs = block_specs(variant)
    if len(specs) != len(model.blocks):
        raise ValueError(f"model has {len(model.blocks)} blocks, variant "
                         f"{variant!r} has {len(specs)}")
    out: Dict[str, Any] = {
        "stem_w": model.stem_conv.weight.detach(),    # (32, 3, 3, 3) OIHW
        "stem_bn": _bn(model.bn0),
        "head_w": _w1x1(model.head_conv),             # (1280, 320)
        "head_bn": _bn(model.bn1),
        "cls_w": model.classifier.weight.detach(),    # (n_cls, 1280)
        "cls_b": model.classifier.bias.detach(),
        "blocks": [],
    }
    for s, m in zip(specs, model.blocks):
        E = s.in_filters * s.expand
        if (m.has_expand != (s.expand != 1) or not m.has_se
                or tuple(m.dw_conv.weight.shape) != (E, 1, s.kernel, s.kernel)
                or m.dw_conv.stride != s.stride
                or m.project_conv.weight.shape[0] != s.out_filters):
            raise ValueError(f"block does not match {s}")
        blk: Dict[str, Any] = {}
        if m.has_expand:
            blk["w_exp"] = _w1x1(m.expand_conv)       # (E, C)
            blk["bn1"] = _bn(m.bn0)
        blk["w_dw"] = m.dw_conv.weight.detach()[:, 0]  # (E, k, k)
        blk["bn2"] = _bn(m.bn1)
        blk["w_se1"] = _w1x1(m.se_reduce)             # (se, E)
        blk["b_se1"] = m.se_reduce.bias.detach()
        blk["w_se2"] = _w1x1(m.se_expand)             # (E, se)
        blk["b_se2"] = m.se_expand.bias.detach()
        blk["w_proj"] = _w1x1(m.project_conv)         # (Cout, E)
        blk["bn3"] = _bn(m.bn2)
        out["blocks"].append(blk)
    return out, specs


# ------------------------------------------------------------ shared math

def _mv(s: Tensor, q: Tensor, count: int) -> Tuple[Tensor, Tensor]:
    mean = s / count
    return mean, torch.clamp(q / count - mean * mean, min=0.0)


def _stats_nchw(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(mean, var) over (N, H, W) in f32; through the channel-sum kernel on
    a CUDA tensor (channels_last memory is a contiguous NHWC view)."""
    return channel_stats(
        x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1))


def _affine(bn, mean: Tensor, var: Tensor) -> Tensor:
    """(2, C) f32: rows a, b with bn(x) = a*x + b."""
    a = bn["scale"].float() * torch.rsqrt(var + BN_EPS)
    return torch.stack([a, bn["bias"].float() - mean * a])


def _apply_affine(x: Tensor, ab: Tensor, dtype) -> Tensor:
    return (x.float() * ab[0][None, :, None, None]
            + ab[1][None, :, None, None]).to(dtype)


def _silu(x: Tensor) -> Tensor:
    """silu with f32 internals, rounded once to x's dtype."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _pw(x: Tensor, w: Tensor) -> Tensor:
    """1x1 conv (N,C,H,W) x (D,C) -> (N,D,H,W): an f32 product of the
    operands as given (already rounded to the compute dtype), rounded to
    x's dtype.  The result is in channels_last memory."""
    out = x.permute(0, 2, 3, 1).float() @ w.float().t()
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _dw_taps(h: Tensor, w_dw: Tensor, stride: int) -> Tensor:
    """Depthwise conv with TF-SAME zero padding as k*k shifted taps, f32
    weights and f32 accumulation in (ki, kj) order; returns f32."""
    k = w_dw.shape[-1]
    H, W = h.shape[2], h.shape[3]
    ph, pw = tf_same_pads(H, k, stride), tf_same_pads(W, k, stride)
    hp = F.pad(h.float(), (pw[0], pw[1], ph[0], ph[1]))
    Ho, Wo = -(-H // stride), -(-W // stride)
    wf = w_dw.float()
    acc = None
    for ki in range(k):
        for kj in range(k):
            win = hp[:, :, ki:ki + (Ho - 1) * stride + 1:stride,
                     kj:kj + (Wo - 1) * stride + 1:stride]
            term = wf[:, ki, kj][None, :, None, None] * win
            acc = term if acc is None else acc + term
    return acc


def _sums(x: Tensor) -> Tuple[Tensor, Tensor]:
    xf = x.float()
    return xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))


# ------------------------------------------------------------ plain versions

def k1_expand_stats_plain(y: Tensor, w_exp: Tensor):
    """Per-channel sum and sum of squares (f32) of round(W_exp . y)."""
    return _sums(_pw(y, w_exp))


def k2_depthwise_plain(y: Tensor, w_exp: Optional[Tensor],
                       ab1: Optional[Tensor], w_dw: Tensor, stride: int):
    """dwout = dw(silu(bn1(W_exp . y))) in y's dtype and its per-channel
    sum, sum of squares; the expand chain is skipped when w_exp is None."""
    h = y
    if w_exp is not None:
        h = _silu(_apply_affine(_pw(y, w_exp), ab1, y.dtype))
    dw = _dw_taps(h, w_dw, stride).to(y.dtype).contiguous(
        memory_format=torch.channels_last)
    return (dw,) + _sums(dw)


def k4_project_plain(dwout: Tensor, ab2: Tensor, se: Tensor, w_proj: Tensor):
    """tmp = W_proj . (se * silu(bn2(dwout))) in dwout's dtype and its
    per-channel sum, sum of squares.  se: (N, E) f32."""
    cd = dwout.dtype
    h2 = _silu(_apply_affine(dwout, ab2, cd))
    scaled = (h2.float() * se[:, :, None, None]).to(cd)
    tmp = _pw(scaled, w_proj)
    return (tmp,) + _sums(tmp)


# ------------------------------------------------------------ wrappers

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_effnet")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.moma_fe_k1.argtypes = [p, p, i32, i64, i32, i32, i32, p, p, p, p, p]
    lib.moma_fe_k1.restype = i32
    lib.moma_fe_k1_rows.argtypes = [i32, i64, i32, i32] + [p] * 4
    lib.moma_fe_k1_rows.restype = i32
    lib.moma_fe_k2.argtypes = [p, p, p, p, p, i32] + [i32] * 14 + [p] * 5
    lib.moma_fe_k2.restype = i32
    lib.moma_fe_k2_rows.argtypes = [i32] * 9 + [p] * 5
    lib.moma_fe_k2_rows.restype = i32
    lib.moma_fe_k4.argtypes = [p, p, p, p, p, i32, i64, i32, i32, i32, i32,
                               p, p, p, p, p]
    lib.moma_fe_k4.restype = i32
    lib.moma_fe_k4_rows.argtypes = [i32, i64, i32, i32, p, p, p]
    lib.moma_fe_k4_rows.restype = i32
    return lib


def _check_map(name: str, what: str, t: Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {what} expected on a CUDA device, got "
                         f"{t.device}")
    if t.ndim != 4 or t.numel() == 0:
        raise ValueError(f"{name}: {what} must be a non-empty (N, C, H, W) "
                         f"tensor, got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: {what} dtype {t.dtype} not in (float32, "
                        "bfloat16)")
    if not t.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError(
            f"{name}: {what} must be in torch.channels_last memory "
            f"(contiguous as N, H, W, C); got strides {t.stride()}")


def _check_mat(name: str, what: str, t: Tensor, shape, dtype, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: {what} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {dev}; got {t.dtype} {tuple(t.shape)} strides "
            f"{t.stride()} on {t.device}")


# per kernel: its C query of the launch plan and how many numbers it gives
_PLANS = {"k1_expand_stats": ("moma_fe_k1_rows", 4),
          "k2_depthwise": ("moma_fe_k2_rows", 5),
          "k4_project": ("moma_fe_k4_rows", 3)}


def launch_plan(name: str, *args) -> Tuple[int, ...]:
    """The launch plan K1 (`name` "k1_expand_stats"), K2 ("k2_depthwise")
    or K4 ("k4_project") takes for these sizes, as csrc/fused_effnet.cu
    picks it from the card: grid.y (one wave of resident blocks, and the
    rows of partial sums the wrapper allocates), dynamic shared memory
    bytes, resident blocks an SM, then for K1 the expanded channels a block
    owns and for K2 its output tile's rows and columns.  args: those of
    moma_fe_k1_rows / moma_fe_k2_rows / moma_fe_k4_rows before the
    outputs."""
    lib = _lib()
    fn, n = _PLANS[name]
    out = [ctypes.c_int(0) for _ in range(n)]
    _build.check(lib, getattr(lib, fn)(*args, *map(ctypes.byref, out)), name)
    return tuple(o.value for o in out)


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sum_buffers(G: int, C: int, dev):
    part = torch.empty((2, G, C), dtype=torch.float32, device=dev)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)
    return part, out


def k1_expand_stats(y: Tensor, w_exp: Tensor):
    """Per-channel sum and sum of squares (f32, (E,)) of round(W_exp . y)
    without writing the expanded tensor.  y: (N, C, H, W) channels_last,
    float32 or bfloat16; w_exp: (E, C) contiguous, y's dtype."""
    if y.device.type == "cpu":
        return k1_expand_stats_plain(y, w_exp)
    _check_map("k1_expand_stats", "y", y)
    N, C, H, W = y.shape
    E = w_exp.shape[0]
    _check_mat("k1_expand_stats", "w_exp", w_exp, (E, C), y.dtype, y.device)
    P = N * H * W
    G = launch_plan("k1_expand_stats", _DTYPE_CODES[y.dtype], P, C, E)[0]
    part, out = _sum_buffers(G, E, y.device)
    lib = _lib()
    rc = lib.moma_fe_k1(
        y.data_ptr(), w_exp.data_ptr(), _DTYPE_CODES[y.dtype], P, C, E, G,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), _stream(y))
    _build.check(lib, rc, "k1_expand_stats")
    count_launch("k1_expand_stats")
    return out[0], out[1]


def k2_depthwise(y: Tensor, w_exp: Optional[Tensor], ab1: Optional[Tensor],
                 w_dw: Tensor, stride: int):
    """dwout = dw_{k,stride}(silu(bn1(W_exp . y))) with TF-SAME zero padding
    around the activation, written once in y's dtype (channels_last), and
    its per-channel sum and sum of squares (f32).  y: (N, C, H, W)
    channels_last; w_exp: (E, C) in y's dtype and ab1: (2, E) f32, or both
    None for a block without expand conv (E = C); w_dw: (E, k, k) f32, k in
    (3, 5); stride in (1, 2)."""
    if y.device.type == "cpu":
        return k2_depthwise_plain(y, w_exp, ab1, w_dw, stride)
    name = "k2_depthwise"
    _check_map(name, "y", y)
    N, C, H, W = y.shape
    E, k = w_dw.shape[0], w_dw.shape[-1]
    if k not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"{name}: kernel {k} / stride {stride} not in "
                         "(3, 5) / (1, 2)")
    _check_mat(name, "w_dw", w_dw, (E, k, k), torch.float32, y.device)
    if (w_exp is None) != (ab1 is None):
        raise ValueError(f"{name}: w_exp and ab1 go together")
    if w_exp is None:
        if E != C:
            raise ValueError(f"{name}: no expand conv but {E} depthwise "
                             f"channels for {C} inputs")
    else:
        _check_mat(name, "w_exp", w_exp, (E, C), y.dtype, y.device)
        _check_mat(name, "ab1", ab1, (2, E), torch.float32, y.device)
    Ho, Wo = -(-H // stride), -(-W // stride)
    G, _, _, toh, tow = launch_plan(name, _DTYPE_CODES[y.dtype], N, C, E, k,
                                    stride, Ho, Wo, int(w_exp is not None))
    dw = torch.empty((N, E, Ho, Wo), dtype=y.dtype, device=y.device,
                     memory_format=torch.channels_last)
    part, out = _sum_buffers(G, E, y.device)
    lib = _lib()
    rc = lib.moma_fe_k2(
        y.data_ptr(), None if w_exp is None else w_exp.data_ptr(),
        None if ab1 is None else ab1.data_ptr(), w_dw.data_ptr(),
        dw.data_ptr(), _DTYPE_CODES[y.dtype], N, H, W, C, E, k, stride, Ho,
        Wo, tf_same_pads(H, k, stride)[0], tf_same_pads(W, k, stride)[0],
        toh, tow, G, part[0].data_ptr(), part[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), _stream(y))
    _build.check(lib, rc, name)
    count_launch(name)
    return dw, out[0], out[1]


def k4_project(dwout: Tensor, ab2: Tensor, se: Tensor, w_proj: Tensor):
    """tmp = W_proj . (se * silu(bn2(dwout))) in dwout's dtype
    (channels_last) and its per-channel sum and sum of squares (f32).
    dwout: (N, E, H, W) channels_last; ab2: (2, E) f32; se: (N, E) f32;
    w_proj: (Cout, E) in dwout's dtype."""
    if dwout.device.type == "cpu":
        return k4_project_plain(dwout, ab2, se, w_proj)
    name = "k4_project"
    _check_map(name, "dwout", dwout)
    N, E, H, W = dwout.shape
    Cout = w_proj.shape[0]
    dev = dwout.device
    _check_mat(name, "ab2", ab2, (2, E), torch.float32, dev)
    _check_mat(name, "se", se, (N, E), torch.float32, dev)
    _check_mat(name, "w_proj", w_proj, (Cout, E), dwout.dtype, dev)
    P = N * H * W
    if P >= 2 ** 31:
        raise ValueError(f"{name}: {P} pixels, more than the kernel's "
                         "32-bit pixel index takes")
    G = launch_plan(name, _DTYPE_CODES[dwout.dtype], P, H * W, Cout)[0]
    tmp = torch.empty((N, Cout, H, W), dtype=dwout.dtype, device=dev,
                      memory_format=torch.channels_last)
    part, out = _sum_buffers(G, Cout, dev)
    lib = _lib()
    rc = lib.moma_fe_k4(
        dwout.data_ptr(), ab2.data_ptr(), se.data_ptr(), w_proj.data_ptr(),
        tmp.data_ptr(), _DTYPE_CODES[dwout.dtype], P, H * W, E, Cout, G,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), _stream(dwout))
    _build.check(lib, rc, name)
    count_launch(name)
    return tmp, out[0], out[1]


# ------------------------------------------------------------ fused forward

def fused_block(blk, spec: BlockSpec, y: Tensor, train: bool,
                collected: list) -> Tensor:
    """One MBConv block through K1 / K2 / K4 (_fused_block,
    fused_effnet_pallas.py:401-503).  y: (N, C, H, W) channels_last in the
    compute dtype; appends the block's (mean, var) pairs to `collected` in
    train mode."""
    cd = y.dtype
    N, _, H, W = y.shape
    w_exp = ab1 = None
    if spec.expand != 1:
        w_exp = blk["w_exp"].to(cd).contiguous()
        if train:
            m1, v1 = _mv(*k1_expand_stats(y, w_exp), N * H * W)
            collected.append((m1, v1))
        else:
            m1, v1 = blk["bn1"]["mean"], blk["bn1"]["var"]
        ab1 = _affine(blk["bn1"], m1, v1)

    dwout, s2, q2 = k2_depthwise(y, w_exp, ab1,
                                 blk["w_dw"].float().contiguous(), spec.stride)
    cnt = N * dwout.shape[2] * dwout.shape[3]
    if train:
        m2, v2 = _mv(s2, q2, cnt)
        collected.append((m2, v2))
    else:
        m2, v2 = blk["bn2"]["mean"], blk["bn2"]["var"]
    ab2 = _affine(blk["bn2"], m2, v2)

    # SE: pooled from the unrounded f32 activation (:464-469)
    h2f = (dwout.float() * ab2[0][None, :, None, None]
           + ab2[1][None, :, None, None])
    pooled = (h2f * torch.sigmoid(h2f)).mean((2, 3)).to(cd)     # (N, E)
    z = F.silu((pooled.float() @ blk["w_se1"].to(cd).float().t()).to(cd)
               + blk["b_se1"].to(cd))
    se = torch.sigmoid((z.float() @ blk["w_se2"].to(cd).float().t()).to(cd)
                       + blk["b_se2"].to(cd)).float()

    tmp, s3, q3 = k4_project(dwout, ab2, se.contiguous(),
                             blk["w_proj"].to(cd).contiguous())
    if train:
        m3, v3 = _mv(s3, q3, cnt)
        collected.append((m3, v3))
    else:
        m3, v3 = blk["bn3"]["mean"], blk["bn3"]["var"]
    out = _apply_affine(tmp, _affine(blk["bn3"], m3, v3), cd)
    if spec.has_skip:
        out = out + y
    return out


def _stem(params, x_nhwc: Tensor, train: bool, collected: list, cd) -> Tensor:
    x = x_nhwc.to(cd).permute(0, 3, 1, 2)      # channels_last NCHW view
    tmp = conv2d_same(x, params["stem_w"].to(cd), None, 2)
    bn = params["stem_bn"]
    if train:
        mean, var = _stats_nchw(tmp)
        collected.append((mean, var))
    else:
        mean, var = bn["mean"], bn["var"]
    return F.silu(_apply_affine(tmp, _affine(bn, mean, var), cd))


def _head(params, y: Tensor, train: bool, collected: list, cd):
    h = F.conv2d(y, params["head_w"].to(cd)[:, :, None, None])
    bn = params["head_bn"]
    if train:
        mean, var = _stats_nchw(h)
        collected.append((mean, var))
    else:
        mean, var = bn["mean"], bn["var"]
    h = F.silu(_apply_affine(h, _affine(bn, mean, var), cd))
    pooled = h.mean((2, 3)).float()
    logits = pooled @ params["cls_w"].float().t() + params["cls_b"].float()
    return pooled, logits


def fused_forward(params, specs: Sequence[BlockSpec], x_nhwc: Tensor,
                  train: bool, compute_dtype=torch.bfloat16):
    """Fused forward of an EfficientNet given by `extract_params`; NHWC
    input.  Stem, SE MLP, finalize and head are torch ops; every MBConv
    block runs K1 (train mode only), K2 and K4.  In eval mode the running
    statistics normalize and K2/K4's sums are ignored.  Returns (pooled f32,
    logits f32, collected): `collected` holds one (mean, var) pair per
    BatchNorm in `bn_order` in train mode and is empty in eval mode."""
    collected: List[Tuple[Tensor, Tensor]] = []
    with torch.no_grad():
        y = _stem(params, x_nhwc, train, collected, compute_dtype)
        for blk, spec in zip(params["blocks"], specs):
            y = fused_block(blk, spec, y, train, collected)
        pooled, logits = _head(params, y, train, collected, compute_dtype)
    return pooled, logits, collected


# ------------------------------------------------------------ reference

def _bn_apply(x: Tensor, bn, train: bool, cd):
    mean, var = _mv(*_sums(x), x.numel() // x.shape[1]) if train else (
        bn["mean"], bn["var"])
    return _apply_affine(x, _affine(bn, mean, var), cd), (mean, var)


def reference_block(blk, s: BlockSpec, h: Tensor, train: bool,
                    collected: list, compute_dtype) -> Tensor:
    """One MBConv block in plain PyTorch with moma_tpu's reference_block
    rounding (fused_effnet.py:213-245): depthwise taps rounded to the
    compute dtype, SE pooled from the rounded activation."""
    cd = compute_dtype
    inp = h
    if s.expand != 1:
        h, st = _bn_apply(_pw(h, blk["w_exp"].to(cd)), blk["bn1"], train, cd)
        if train:
            collected.append(st)
        h = F.silu(h)
    h = _dw_taps(h, blk["w_dw"].to(cd), s.stride).to(cd)
    h, st = _bn_apply(h, blk["bn2"], train, cd)
    if train:
        collected.append(st)
    h = F.silu(h)
    pooled = h.mean((2, 3))
    z = F.silu((pooled.float() @ blk["w_se1"].to(cd).float().t()).to(cd)
               + blk["b_se1"].to(cd))
    z = torch.sigmoid((z.float() @ blk["w_se2"].to(cd).float().t()).to(cd)
                      + blk["b_se2"].to(cd))
    h = h * z[:, :, None, None]
    h, st = _bn_apply(_pw(h, blk["w_proj"].to(cd)), blk["bn3"], train, cd)
    if train:
        collected.append(st)
    return h + inp if s.has_skip else h


def reference_forward(params, specs: Sequence[BlockSpec], x_nhwc: Tensor,
                      train: bool, compute_dtype=torch.bfloat16):
    """Plain PyTorch forward with reference_forward's rounding points
    (fused_effnet.py:248-281); NHWC input like fused_forward.  Returns
    (pooled f32, logits f32, collected)."""
    collected: List[Tuple[Tensor, Tensor]] = []
    with torch.no_grad():
        h = _stem(params, x_nhwc, train, collected, compute_dtype)
        for blk, s in zip(params["blocks"], specs):
            h = reference_block(blk, s, h, train, collected, compute_dtype)
        pooled, logits = _head(params, h, train, collected, compute_dtype)
    return pooled, logits, collected


# ------------------------------------------------------------ running stats

def bn_order(params, specs: Sequence[BlockSpec]) -> List[Dict[str, Tensor]]:
    """The BN entries of `params` in the order the forwards collect their
    statistics: stem, each block's bn1 (with expand conv), bn2, bn3, head."""
    order = [params["stem_bn"]]
    for blk, s in zip(params["blocks"], specs):
        if s.expand != 1:
            order.append(blk["bn1"])
        order += [blk["bn2"], blk["bn3"]]
    order.append(params["head_bn"])
    return order


@torch.no_grad()
def updated_batch_stats(params, specs: Sequence[BlockSpec],
                        collected) -> None:
    """ra <- m*ra + (1-m)*batch on every running mean / variance, in place
    through the views of `params` (so on the module they came from);
    m = BN_MOMENTUM, biased batch variance (fused_effnet.py:301-325)."""
    order = bn_order(params, specs)
    if len(order) != len(collected):
        raise ValueError(f"{len(collected)} statistics pairs for "
                         f"{len(order)} BatchNorms")
    ras = [bn[k] for bn in order for k in ("mean", "var")]
    new = torch._foreach_mul([t for pair in collected for t in pair],
                             1.0 - BN_MOMENTUM)
    torch._foreach_mul_(ras, BN_MOMENTUM)
    torch._foreach_add_(ras, new)
