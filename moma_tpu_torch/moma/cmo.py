"""CMO — projection heads + batch-token attention.

Counterpart of moma_tpu/moma/cmo.py: `BatchTokenAttention` (:28-58, heads
over the BATCH ROWS as tokens), `BatchTokenAttention2` (:61-75, residual +
LayerNorm), `ProjectionHead` (:78-115; heads 'mlp', 'mlp_byol', 'linear',
'None'), `CMOHeads` (:146-293) with the full `ATTN_SETS` table, its
`include_ema` head for cross-arch runs and `attn_maps` (the self_viz
maps), `RFFHead` (:312-356) and `CMOEmaTecHeads` (:359-392).  Modules are
registered in the order moma_tpu's `init` creates their parameters
(embed_s, embed_t, embed_ema, then the attention set; CMOEmaTecHeads:
embed_s, embed_ema, embed_t), so moma_tpu_torch.interop carries their
weights across.

A plain `BatchTokenAttention` over more than `DENSE_MAX_TOKENS` tokens
(MoCoAtt 'all' / 'dual' attend over 2B+K) goes through the streaming
flash-attention kernels (ops/flash_attention.py), as `CMOHeads.attn_fns`
routes it in the JAX package (:202-233); the `Attention2` modes stay dense
at any size, as there.

Waiting for a later slice: `ring_attn_fns` (the sharded bank, ROADMAP
Queue 1 item 5).  'self_viz' trains exactly as 'self'.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from moma_tpu_torch.core.config import HEADS
from moma_tpu_torch.losses.functional import l2_normalize
from moma_tpu_torch.models.common import TorchLinear, default_generator
from moma_tpu_torch.ops.flash_attention import batch_token_attention_big
from moma_tpu_torch.ops.fused_bn import FusedBatchNorm

# attention-set layouts per --attn (cmo.py:119-141)
ATTN_SETS = {
    "all": ("atts",),
    "self_mix": ("atts",),
    "qk": ("atts",),
    "dual": ("atts_p", "atts_n"),
    "dual2": ("atts_p", "atts_n"),
    "self_qk": ("atts_q", "atts_k"),
    "self_nomix": ("atts_q", "atts_k"),
    "self_qkv2": ("atts_q", "atts_k"),
    "selfv2": ("atts_q", "atts_k", "atts_queue"),
    "self": ("atts_q", "atts_k", "atts_queue"),
    "self_viz": ("atts_q", "atts_k", "atts_queue"),
    "none": (),
}
# modes built from Attention2 (residual + LayerNorm)
ATTN2_MODES = {"self_qkv2", "selfv2"}
DENSE_MAX_TOKENS = 2048


class BatchTokenAttention(nn.Module):
    """MHSA over the batch-as-token axis; input/output (N, C); scale
    head_dim^-0.5, no residual, no norm.  `forward` picks the streaming
    path above DENSE_MAX_TOKENS tokens; `dense` never does, and with
    `return_attn` also returns the (H, N, N) attention map (the
    Attention_viz variant, cmo.py:28-58)."""

    def __init__(self, dim: int, num_heads: int = 4, qkv_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.num_heads = num_heads
        self.qkv = TorchLinear(dim, 3 * dim, use_bias=qkv_bias, generator=g)
        self.proj = TorchLinear(dim, dim, generator=g)

    def dense(self, x: torch.Tensor, return_attn: bool = False):
        N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(N, 3, H, hd).permute(1, 2, 0, 3)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
        y = (attn @ v).permute(1, 0, 2).reshape(N, C)
        if return_attn:
            return self.proj(y), attn
        return self.proj(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] <= DENSE_MAX_TOKENS:
            return self.dense(x)
        return batch_token_attention_big(
            x, self.qkv.weight.t(), self.qkv.bias, self.proj.weight.t(),
            self.proj.bias, self.num_heads)


class BatchTokenAttention2(nn.Module):
    """Attention + residual + LayerNorm (flax default eps 1e-6); always
    dense, whatever the token count."""

    def __init__(self, dim: int, num_heads: int = 4, qkv_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn_layer = BatchTokenAttention(dim, num_heads, qkv_bias,
                                              generator=generator)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn_layer.dense(x) + x
        # flax LayerNorm normalizes in float32 and returns the input dtype
        return self.norm(y.float()).to(y.dtype)


class ProjectionHead(nn.Module):
    """embed_s / embed_t head, output L2-normalized in float32:
      'mlp'      Linear(d,d)-ReLU-Linear(d,feat)
      'mlp_byol' Linear(d,d)-BN1d-ReLU-Linear(d,feat); the BN has flax
                 numerics (momentum 0.9, eps 1e-5, biased variance in the
                 running update) and follows module.train() / eval()
      'linear'   Linear(d,feat)
      'None'     flatten only"""

    def __init__(self, head: str, in_dim: int, feat_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; known: {HEADS}")
        g = default_generator(generator)
        self.head = head
        if head in ("mlp", "mlp_byol"):
            self.fc0 = TorchLinear(in_dim, in_dim, generator=g)
            if head == "mlp_byol":
                self.bn = FusedBatchNorm(in_dim, momentum=0.9, eps=1e-5)
            self.fc1 = TorchLinear(in_dim, feat_dim, generator=g)
        elif head == "linear":
            self.fc0 = TorchLinear(in_dim, feat_dim, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        if self.head == "mlp":
            x = self.fc1(torch.relu(self.fc0(x)))
        elif self.head == "mlp_byol":
            x = self.fc1(torch.relu(self.bn(self.fc0(x)).to(x.dtype)))
        elif self.head == "linear":
            x = self.fc0(x)
        return l2_normalize(x.float(), dim=1)


class CMOHeads(nn.Module):
    """embed_s (SGD-trained), embed_t (same-arch: EMA-tracked from embed_s
    for the mlp heads, else parameter-free or fixed; cross-arch: the fixed
    teacher's head, in the SGD chain with a zero gradient), with
    `include_ema` embed_ema (cross-arch: the key head, EMA-tracked from
    embed_s), and the attention set of `attn`."""

    def __init__(self, head: str, attn: str, feat_dim: int, s_dim: int,
                 t_dim: int, generator: Optional[torch.Generator] = None,
                 include_ema: bool = False):
        super().__init__()
        if attn not in ATTN_SETS:
            # no silent fallback: a typo would train another model than asked
            raise ValueError(
                f"unknown attn mode {attn!r}; known: {sorted(ATTN_SETS)}")
        g = default_generator(generator)
        self.embed_s = ProjectionHead(head, s_dim, feat_dim, generator=g)
        self.embed_t = ProjectionHead(head, t_dim, feat_dim, generator=g)
        # registered between embed_t and the attention set, JAX's init order
        self.embed_ema = (ProjectionHead(head, s_dim, feat_dim, generator=g)
                          if include_ema else None)
        self.mode = attn
        att_cls = (BatchTokenAttention2 if attn in ATTN2_MODES
                   else BatchTokenAttention)
        self.attn = nn.ModuleDict({
            name: att_cls(feat_dim, num_heads=4, qkv_bias=True, generator=g)
            for name in ATTN_SETS[attn]})

    def attn_fns(self) -> Dict[str, Callable]:
        """{name: callable} over the live attention modules, the argument
        `step_moco_att` takes (cmo.py:202-233)."""
        return dict(self.attn.items())

    def attn_maps(self, inputs: Dict[str, torch.Tensor]
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{module name: (out, (H, N, N) map)} over the dense path for the
        modules named in `inputs` ((N, C) tokens each), as cmo.py:271-293;
        the Attention2 modes have no map and raise."""
        out = {}
        for name, mod in self.attn.items():
            if name not in inputs:
                continue
            if isinstance(mod, BatchTokenAttention2):
                raise ValueError(
                    f"attn mode {self.mode!r} uses Attention2 modules, "
                    "which have no attention-map output")
            out[name] = mod.dense(inputs[name], return_attn=True)
        return out


class RFFHead(nn.Module):
    """Random-Fourier-feature head: sqrt(2/in_dim) * cos(x @ W + b), W ~
    N(0, 1) * w_scale, b ~ U(0, 6.283) * b_scale (cmo.py:312-356).  With
    `fixed`, W and b are buffers drawn once from `generator` at
    construction (the JAX package's 'constants'; interop carries them);
    without it each call takes its draws: `draws` = (W, b) unscaled, or a
    `generator` to draw them from.  Never a draw of its own choosing."""

    def __init__(self, in_dim: int, out_dim: int = 128, w_scale: float = 1.0,
                 b_scale: float = 1.0, fixed: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.w_scale, self.b_scale, self.fixed = w_scale, b_scale, fixed
        if fixed:
            g = default_generator(generator)
            self.register_buffer("B_w", torch.randn(
                in_dim, out_dim, generator=g) * w_scale)
            self.register_buffer("B_b", torch.rand(
                1, out_dim, generator=g) * 6.283 * b_scale)

    def forward(self, x: torch.Tensor, draws=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        if self.fixed:
            W, b = self.B_w, self.B_b
        else:
            if draws is None:
                if generator is None:
                    raise ValueError("a non-fixed RFFHead needs its draws "
                                     "or a generator for each call")
                draws = (torch.randn(self.in_dim, self.out_dim,
                                     generator=generator),
                         torch.rand(1, self.out_dim, generator=generator)
                         * 6.283)
            W = draws[0].to(x.device) * self.w_scale
            b = draws[1].to(x.device) * self.b_scale
        return math.sqrt(2.0 / x.shape[-1]) * torch.cos(x @ W + b)


class CMOEmaTecHeads(nn.Module):
    """The three heads of the reference's CMO_EmaTec (cmo.py:359-392):
    embed_s (student), embed_ema (the EMA student copy) and embed_t (the
    fixed teacher), registered in that order."""

    def __init__(self, head: str, feat_dim: int, s_dim: int, t_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.embed_s = ProjectionHead(head, s_dim, feat_dim, generator=g)
        self.embed_ema = ProjectionHead(head, s_dim, feat_dim, generator=g)
        self.embed_t = ProjectionHead(head, t_dim, feat_dim, generator=g)

    def embed(self, which: str, x: torch.Tensor,
              train: bool = True) -> torch.Tensor:
        mod = getattr(self, which)
        mod.train(train)
        return mod(x)
