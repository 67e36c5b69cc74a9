"""Backbone registry (the EfficientNet and ViT / DeiT families of
moma_tpu.models)."""

from __future__ import annotations

from typing import Optional

import torch

_EFFNETS = {f"effiB{i}": f"b{i}" for i in range(8)}
# ViT / DeiT, with the timm-flavoured aliases of moma_tpu/models/__init__.py
# (:67-84; architecturally the vit_* factories)
_VITS = {name: name for name in (
    "vit_base_patch16_224", "vit_tiny_patch16_224", "vit_small_patch16_224",
    "deit_base_patch16_224", "deit_tiny_patch16_224",
    "deit_small_patch16_224", "vit_tiny_patch16_384",
    "vit_base_patch16_384", "deit_base_patch16_384",
    "deit_tiny_patch16_384")}
_VITS.update({"vit_timm_base_patch16_224": "vit_base_patch16_224",
              "vit_timm_tiny_patch16_224": "vit_tiny_patch16_224"})


def available_models():
    return sorted([*_EFFNETS, *_VITS])


def create_model(name: str, num_classes: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 image_size: Optional[int] = None):
    """Build a registered backbone (moma_tpu/models/__init__.py
    counterpart).  A ViT needs `image_size`: its position embedding is
    sized from it."""
    if name in _EFFNETS:
        from moma_tpu_torch.models.efficientnet import EfficientNet

        return EfficientNet(_EFFNETS[name], num_classes=num_classes,
                            dtype=dtype, generator=generator)
    if name in _VITS:
        if image_size is None:
            raise ValueError(f"{name} needs image_size: its position "
                             "embedding is sized from it")
        from moma_tpu_torch.models.vit import vit_factory

        return vit_factory(_VITS[name], num_classes, image_size, dtype=dtype,
                           generator=generator)
    raise NotImplementedError(
        f"model {name!r} is not ported to moma_tpu_torch yet (ported: "
        f"{available_models()}; the rest of the model zoo is ROADMAP Queue 1 "
        "item 3)")
