"""ViT / DeiT family — the cross-arch teachers of MoMA.

Counterpart of moma_tpu/models/vit.py: `MHSA` (:23-41), `Block` (:44-57),
`VisionTransformer` (:60-96) and the ten factories (:99-124).  The feature
contract is the JAX package's: forward(NHWC images) -> ((grid, cls_out),
logits), `grid` the token grid as an NHWC map (the layout of the port's
EfficientNet feature maps), `cls_out` the final-norm cls token in float32,
and the classifier on that float32 token; `feat_dim = dim`.

Numerics follow flax: LayerNorm eps 1e-6 with float32 statistics, cast to
the compute dtype; exact (erf) GELU; the attention softmax in float32, cast
to the compute dtype before `attn @ v`.  Attention is two plain matmuls a
head: no Pallas kernel exists for it in the JAX package, and
the library's fused attention call rounds P at other points.

The position embedding's length is fixed at construction from
`image_size` (the JAX package sizes it from the init input, :79-88); an
input of another size raises.  Parameters are float32 and cast at use to
`dtype` (flax's `dtype=`), as in models/common.py.  Every draw comes from
an explicit generator: flax's initializers (lecun-normal truncated Dense
and patch kernels, zero biases, truncated normal 0.02 for the cls token
and the position embedding, torch's default for the classifier).

Weights cross packages through moma_tpu_torch.interop's explicit name map
(`vit_name_map`), not the stream converter.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import Conv2d, TorchLinear, default_generator

LN_EPS = 1e-6
# lecun_normal = variance_scaling(1, fan_in, truncated_normal): the std of a
# unit normal truncated at +-2 is 0.8796, so the draw is scaled up by it
_TRUNC_STD = 0.87962566103423978


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(epsilon=1e-6, dtype=dtype): statistics and the
    affine in float32, the result cast to `dtype` (None: the promotion of
    the input with float32)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = (self.dtype if self.dtype is not None
               else torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            LN_EPS).to(out)


class Dense(nn.Module):
    """flax nn.Dense(dtype=dtype): input, kernel and bias cast to `dtype`
    (None: promoted) at use; weight (out, in) as torch stores it."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        _lecun_(self.weight, in_features, default_generator(generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = (self.dtype if self.dtype is not None
              else torch.promote_types(x.dtype, self.weight.dtype))
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MHSA(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype, generator)
        self.proj = Dense(dim, dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        y = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(y)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = MHSA(dim, num_heads, dtype, generator)
        self.norm2 = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype, generator)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h)


class ViTBase(nn.Module):
    """What the ViT families share (this file's VisionTransformer and
    models/vit_moe.MoEVisionTransformer, which are not each other's
    subclasses): the patch embedding, the cls token and position
    embedding, the final norm, the classifier, and the forward around
    `run_blocks`."""

    def _embeddings(self, patch_size: int, dim: int, num_heads: int,
                    image_size: int, dtype: Optional[torch.dtype],
                    g: torch.Generator) -> None:
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} is not a multiple of "
                             f"the patch size {patch_size}")
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.grid = image_size // patch_size
        self.patch_embed = Conv2d(3, dim, patch_size, patch_size, bias=True,
                                  dtype=dtype, generator=g)
        _lecun_(self.patch_embed.weight, 3 * patch_size * patch_size, g)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid ** 2 + 1, dim))
        with torch.no_grad():
            for p in (self.cls_token, self.pos_embed):
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=g)

    def _head(self, dim: int, num_classes: int, dtype: Optional[torch.dtype],
              g: torch.Generator) -> None:
        self.norm = LayerNorm(dim, dtype)
        self.classifier = TorchLinear(dim, num_classes, generator=g)
        self.feat_dim = dim

    def forward(self, x: torch.Tensor):
        B, H, W, _ = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        if gh * gw + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"input {H}x{W} gives {gh * gw} patches; this model's "
                f"position embedding holds {self.pos_embed.shape[1] - 1}")
        x = self.patch_embed(x.permute(0, 3, 1, 2))      # (B, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)                  # (B, gh*gw, dim)
        cls = self.cls_token.to(x.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.norm(self.run_blocks(x))
        cls_out = x[:, 0].float()
        grid = x[:, 1:].reshape(B, gh, gw, x.shape[-1])
        return (grid, cls_out), self.classifier(cls_out)

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The transformer blocks over the tokens (B, 1 + patches, dim);
        the model-parallel teachers (models/vit_tp.py, vit_pp.py,
        vit_moe.EPMoEVisionTransformer) run their shares of them here."""
        for blk in self.blocks:
            x = blk(x)
        return x


class VisionTransformer(ViTBase):
    """forward(NHWC images of image_size^2) -> ((grid NHWC, cls_out f32),
    logits)."""

    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, num_classes: int = 1000,
                 image_size: int = 224, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self._embeddings(patch_size, dim, num_heads, image_size, dtype, g)
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, generator=g)
            for _ in range(depth))
        self._head(dim, num_classes, dtype, g)


# name -> (dim, depth, heads); patch 16.  The 384 variants are the same
# architecture: the position embedding follows the image size.
VIT_CONFIGS = {
    "vit_tiny_patch16_224": (192, 12, 3),
    "vit_small_patch16_224": (384, 12, 6),
    "vit_base_patch16_224": (768, 12, 12),
    "deit_tiny_patch16_224": (192, 12, 3),
    "deit_small_patch16_224": (384, 12, 6),
    "deit_base_patch16_224": (768, 12, 12),
    "vit_tiny_patch16_384": (192, 12, 3),
    "vit_base_patch16_384": (768, 12, 12),
    "deit_base_patch16_384": (768, 12, 12),
    "deit_tiny_patch16_384": (192, 12, 3),
}


def vit_factory(name: str, num_classes: int, image_size: int,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None
                ) -> VisionTransformer:
    dim, depth, heads = VIT_CONFIGS[name]
    return VisionTransformer(16, dim, depth, heads, num_classes, image_size,
                             dtype=dtype, generator=generator)
