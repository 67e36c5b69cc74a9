"""Device-side augmentation primitives.

Counterpart of moma_tpu/data/augment.py: `normalize` (:27),
`random_hflip` (:57), `random_resized_crop` (:75), `resize_bilinear`
(:161) and `center_crop` (:169).  Images are NHWC, as in moma_tpu, so the
two packages compare like with like.

The crop is torchvision's RandomResizedCrop with moma_tpu's arithmetic:
`random_resized_crop_from_draws` takes the four per-image draws (so a
test can pass in the JAX function's own), `random_resized_crop` draws
them from a CPU generator.  The bilinear resize of each crop is a product
with two clamped tent matrices, one per axis, in float32 (moma_tpu's
resize-as-matmul; torch.backends.cuda.matmul.allow_tf32 left off keeps the
products float32 on a card).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# channel stats (reference dataset/cifar100.py:79-86)
CIFAR100_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR100_STD = (0.2675, 0.2565, 0.2761)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """uint8 [0,255] (or float [0,1]) NHWC -> normalized float32."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def random_hflip(images: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    """Flip each NHWC image along W with probability p (flip bits drawn on
    the host from `generator`)."""
    B = images.shape[0]
    flip = (torch.rand(B, generator=generator) < p).to(images.device)
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def random_resized_crop_from_draws(
        images: torch.Tensor, area_frac: torch.Tensor,
        log_ratio: torch.Tensor, u_i: torch.Tensor, u_j: torch.Tensor,
        out_size: int) -> torch.Tensor:
    """(B, H, W, C) -> float32 (B, out_size, out_size, C): each image's
    crop of area H*W*area_frac and aspect exp(log_ratio) at origin
    floor(u * (H - h + 1)), floor(u * (W - w + 1)), resized bilinearly
    with half-pixel centers.  The draws are (B,) float32 on any device."""
    B, H, W, C = images.shape
    dev = images.device
    f32 = dict(dtype=torch.float32, device=dev)
    area_frac, log_ratio, u_i, u_j = (t.to(**f32) for t in
                                      (area_frac, log_ratio, u_i, u_j))
    target_area = (H * W) * area_frac
    aspect = torch.exp(log_ratio)
    w = torch.sqrt(target_area * aspect).round().clamp(1, W)
    h = torch.sqrt(target_area / aspect).round().clamp(1, H)
    i = torch.floor(u_i * (H - h + 1))
    j = torch.floor(u_j * (W - w + 1))
    # XLA takes linspace(0, 1, S, endpoint=False) as iota * (1 / S)
    ys = torch.arange(out_size, **f32) * (1.0 / out_size) + 0.5 / out_size
    src_y = i[:, None] + ys[None, :] * h[:, None] - 0.5   # (B, S)
    src_x = j[:, None] + ys[None, :] * w[:, None] - 0.5

    def interp_matrix(src, L):
        # M[b, l, s] = max(0, 1 - |src[b, s] - l|), rows clamped at borders
        grid = torch.arange(L, **f32)[None, :, None]
        s = src.clamp(0.0, L - 1)[:, None, :]
        return torch.clamp(1.0 - (s - grid).abs(), min=0.0)   # (B, L, S)

    x = images.to(torch.float32)
    x = torch.einsum("bhs,bhwc->bswc", interp_matrix(src_y, H), x)
    return torch.einsum("bwt,bswc->bstc", interp_matrix(src_x, W), x)


def random_resized_crop(
        images: torch.Tensor, generator: torch.Generator, out_size: int,
        scale: Tuple[float, float] = (0.2, 1.0),
        ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> torch.Tensor:
    """torchvision RandomResizedCrop over the batch: the area fraction
    uniform in `scale`, the log aspect uniform in log(`ratio`), the origin
    uniform; four (B,) draws from the CPU `generator`."""
    B = images.shape[0]
    u = torch.rand(4, B, generator=generator)
    area_frac = scale[0] + (scale[1] - scale[0]) * u[0]
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    log_ratio = lo + (hi - lo) * u[1]
    return random_resized_crop_from_draws(images, area_frac, log_ratio,
                                          u[2], u[3], out_size)


def resize_bilinear(images: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers, NHWC float32; antialiased
    when it shrinks, as jax.image.resize(..., 'bilinear') is."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    B, H, W, C = images.shape
    top = (H - size) // 2
    left = (W - size) // 2
    return images[:, top:top + size, left:left + size, :]
