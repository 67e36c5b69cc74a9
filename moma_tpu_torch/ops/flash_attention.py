"""Streaming (flash) attention for the CMO batch-token attention.

Counterpart of moma_tpu/ops/flash_attention.py.  MoCoAtt 'all' attends over
2B+K tokens; at K=16384 a dense (H, N, N) float32 score tensor is 4.4 GB
per copy, so the scores are streamed tile by tile and never stored.  The
three Pallas kernels become CUDA kernels in csrc/flash_attention.cu:

  flash_fwd  <- _flash_fwd_kernel (flash_attention.py:112-145, via
                _flash_forward :148-184): o = softmax(qs k^T) v plus the
                row max m and row sum l
  flash_dq   <- _flash_dq_kernel  (:203-237, via _flash_backward :294-305):
                dqs = sum_j ds_ij k_j
  flash_dkv  <- _flash_dkv_kernel (:240-278, via _flash_backward :311-326):
                dv = sum_i p_ij dO_i, dk = sum_i ds_ij qs_i

with p = exp(s - m) / l and ds = p * (dO v^T - delta).  What bounds them on
an H100 is operations (thousands of flops per byte moved); the design — one
block per (head, row tile) looping over the other axis, no atomics; forward
and dq on the tensor cores as three TF32 products per float32 product — is
described at the top of the CUDA source.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain PyTorch version beside it, a Python loop over key
chunks with the same arithmetic (the chunked route of the JAX module,
:345-384 and :454-484), so memory stays O(N * chunk) there too.  There is
no fall back from one to the other and no flag that chooses.

As in the JAX module the query is scaled outside the kernels, in the input
dtype (:155), the backward returns dq = dqs * scale (:305) and
delta = rowsum(dO * o) is taken in float32 outside (:288).  With bf16
inputs p and ds are rounded to bf16 before the second product, in the
kernels and in the plain versions alike.  The TPU block-size pickers
(pick_blocks / _pick_bk) have no counterpart: the kernels take any N and
mask their last tile by index, so there is no key padding and no n_real.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from moma_tpu_torch.ops import _build
from moma_tpu_torch.runtime import count_launch

NEG_INF = -1e30
CHUNK = 1024
MAX_HEAD_DIM = 128   # csrc/flash_attention.cu: widest instance
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moma_flash_fwd.argtypes = [p] * 6 + [i32] * 5 + [p]
    lib.moma_flash_fwd.restype = i32
    lib.moma_flash_dq.argtypes = [p] * 8 + [i32] * 5 + [p]
    lib.moma_flash_dq.restype = i32
    lib.moma_flash_dkv.argtypes = [p] * 9 + [i32] * 5 + [p]
    lib.moma_flash_dkv.restype = i32
    lib.moma_flash_smem_bytes.argtypes = [i32] * 3
    lib.moma_flash_smem_bytes.restype = i32
    return lib


def _check_cuda_inputs(name: str, qs, k, v, do=None, stats=()) -> None:
    ts = [t for t in (qs, k, v, do) if t is not None]
    for t in ts + list(stats):
        if t.device.type != "cuda" or t.device != qs.device:
            raise ValueError(f"{name}: expected tensors on {qs.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous, got "
                             f"strides {t.stride()} for {tuple(t.shape)}")
    for t in ts:
        if t.dtype not in _DTYPE_CODES or t.dtype != qs.dtype:
            raise TypeError(f"{name}: q, k, v, dO must share one dtype of "
                            f"(float32, bfloat16); got {t.dtype} / {qs.dtype}")
    if qs.ndim != 3 or k.ndim != 3 or qs.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{name}: expected non-empty (H, N, d) tensors, got "
                         f"{tuple(qs.shape)} / {tuple(k.shape)}")
    H, Nq, d = qs.shape
    if k.shape[0] != H or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not match q {tuple(qs.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} exceeds {MAX_HEAD_DIM}")
    if do is not None and do.shape != qs.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q "
                         f"{tuple(qs.shape)}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (H, Nq, 1):
            raise ValueError(f"{name}: m, l, delta must be float32 "
                             f"({H}, {Nq}, 1); got {t.dtype} "
                             f"{tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _round_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype`, back in float32 (a no-op for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


# --------------------------------------------------------------- plain

def _forward_stats(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   chunk: int = CHUNK):
    """softmax(qs k^T) v by online softmax over key chunks; qs pre-scaled.
    Returns (o in qs.dtype, m, l), m and l (H, N, 1) float32."""
    H, N, d = qs.shape
    q32 = qs.float()
    m = torch.full((H, N, 1), NEG_INF, dtype=torch.float32, device=qs.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((H, N, d), dtype=torch.float32, device=qs.device)
    for c0 in range(0, k.shape[1], chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        s = q32 @ k_i.transpose(1, 2)
        m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _round_as(p, v.dtype) @ v_i
        m = m_new
    return (acc / l).to(qs.dtype), m, l


def _tile_grads(q32, g32, k_i, v_i, m, l, delta, dtype):
    """(p, ds) of one key chunk, rounded as the second products take them."""
    k32, v32 = k_i.float(), v_i.float()
    p = torch.exp(q32 @ k32.transpose(1, 2) - m) / l
    ds = p * (g32 @ v32.transpose(1, 2) - delta)
    return _round_as(p, dtype), _round_as(ds, dtype), k32


def flash_dq_plain(qs, k, v, do, m, l, delta, chunk: int = CHUNK):
    """dqs = sum_j ds_ij k_j, float32 (H, N, d)."""
    q32, g32 = qs.float(), do.float()
    dqs = torch.zeros_like(q32)
    for c0 in range(0, k.shape[1], chunk):
        _, ds, k32 = _tile_grads(q32, g32, k[:, c0:c0 + chunk],
                                 v[:, c0:c0 + chunk], m, l, delta, qs.dtype)
        dqs = dqs + ds @ k32
    return dqs


def flash_dkv_plain(qs, k, v, do, m, l, delta, chunk: int = CHUNK):
    """dk = sum_i ds_ij qs_i and dv = sum_i p_ij dO_i, float32 (H, Nk, d)."""
    q32, g32 = qs.float(), do.float()
    dks, dvs = [], []
    for c0 in range(0, k.shape[1], chunk):
        p, ds, _ = _tile_grads(q32, g32, k[:, c0:c0 + chunk],
                               v[:, c0:c0 + chunk], m, l, delta, qs.dtype)
        dvs.append(p.transpose(1, 2) @ g32)
        dks.append(ds.transpose(1, 2) @ q32)
    return torch.cat(dks, 1), torch.cat(dvs, 1)


# --------------------------------------------------------------- wrappers

def flash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int = CHUNK):
    """(o, m, l) of softmax(qs k^T) v for contiguous qs (H, N, d) and
    k, v (H, Nk, d), float32 or bfloat16; qs is pre-scaled.  `chunk` is the
    plain version's key chunk (CPU tensors only)."""
    if qs.device.type == "cpu":
        return _forward_stats(qs, k, v, chunk)
    _check_cuda_inputs("flash_fwd", qs, k, v)
    H, Nq, d = qs.shape
    o = torch.empty_like(qs)
    m = torch.empty((H, Nq, 1), dtype=torch.float32, device=qs.device)
    l = torch.empty_like(m)
    lib = _lib()
    rc = lib.moma_flash_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), _DTYPE_CODES[qs.dtype], H, Nq,
        k.shape[1], d, _stream(qs))
    _build.check(lib, rc, "flash_fwd")
    count_launch("flash_fwd")
    return o, m, l


def flash_dq(qs, k, v, do, m, l, delta, chunk: int = CHUNK) -> torch.Tensor:
    """dqs (H, N, d) float32, the gradient of the pre-scaled query."""
    if qs.device.type == "cpu":
        return flash_dq_plain(qs, k, v, do, m, l, delta, chunk)
    _check_cuda_inputs("flash_dq", qs, k, v, do, (m, l, delta))
    H, Nq, d = qs.shape
    dq = torch.empty((H, Nq, d), dtype=torch.float32, device=qs.device)
    lib = _lib()
    rc = lib.moma_flash_dq(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _DTYPE_CODES[qs.dtype], H, Nq, k.shape[1], d, _stream(qs))
    _build.check(lib, rc, "flash_dq")
    count_launch("flash_dq")
    return dq


def flash_dkv(qs, k, v, do, m, l, delta,
              chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (H, Nk, d) float32."""
    if qs.device.type == "cpu":
        return flash_dkv_plain(qs, k, v, do, m, l, delta, chunk)
    _check_cuda_inputs("flash_dkv", qs, k, v, do, (m, l, delta))
    H, Nq, d = qs.shape
    dk = torch.empty((H, k.shape[1], d), dtype=torch.float32,
                     device=qs.device)
    dv = torch.empty_like(dk)
    lib = _lib()
    rc = lib.moma_flash_dkv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _DTYPE_CODES[qs.dtype], H, Nq, k.shape[1], d,
        _stream(qs))
    _build.check(lib, rc, "flash_dkv")
    count_launch("flash_dkv")
    return dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v for (H, N, d) inputs, forward only."""
    return flash_fwd(q * scale, k, v)[0]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """The plain streaming forward (same arithmetic as the kernel, a loop
    over key chunks) on whatever device the tensors are."""
    return _forward_stats(q * scale, k, v, chunk)[0]


# --------------------------------------------------------------- autograd

class StreamingAttention(torch.autograd.Function):
    """softmax(scale * q k^T) v with the exact flash backward: the forward
    keeps (o, m, l), the backward rebuilds each probability tile from them
    (flash_attention.py:393-487)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, chunk: int):
        o, m, l = flash_fwd(q * scale, k, v, chunk)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.scale, ctx.chunk = scale, chunk
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l = ctx.saved_tensors
        scale, chunk = ctx.scale, ctx.chunk
        g = g.contiguous()
        qs = q * scale  # the forward's scaling point
        delta = (g.float() * o.float()).sum(-1, keepdim=True)
        dqs = flash_dq(qs, k, v, g, m, l, delta, chunk)
        dk, dv = flash_dkv(qs, k, v, g, m, l, delta, chunk)
        return ((dqs * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None)


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """Differentiable streaming attention over contiguous (H, N, d)
    tensors; O(N * tile) memory in both directions."""
    return StreamingAttention.apply(q, k, v, scale, chunk)


def batch_token_attention_big(x: torch.Tensor, qkv_kernel: torch.Tensor,
                              qkv_bias: Optional[torch.Tensor],
                              proj_kernel: torch.Tensor,
                              proj_bias: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """The many-token path of moma.cmo.BatchTokenAttention: (N, C) tokens
    -> (N, C) through streaming attention (flash_attention.py:490-509).
    Kernels are (in, out), as in the JAX package; the two projections stay
    plain matrix products."""
    N, C = x.shape
    H = num_heads
    hd = C // H
    qkv = x @ qkv_kernel.to(x.dtype)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(x.dtype)
    qkv = qkv.reshape(N, 3, H, hd).permute(1, 2, 0, 3).contiguous()
    out = streaming_attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)
    out = out.permute(1, 0, 2).reshape(N, C)
    return out @ proj_kernel.to(x.dtype) + proj_bias.to(x.dtype)
