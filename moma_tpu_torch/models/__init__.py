"""Backbone registry: every name of moma_tpu/models/__init__.py (:13-91),
aliases included.  `create_model(name, ...)` is the one construction
entry point; imports are lazy."""

from __future__ import annotations

import importlib
from typing import Optional

import torch

_P = "moma_tpu_torch.models."
# name -> (module, factory)
_REGISTRY = {
    # CIFAR ResNet / WRN family
    **{name: (_P + "resnet_cifar", name) for name in (
        "resnet8", "resnet14", "resnet20", "resnet32", "resnet38",
        "resnet44", "resnet56", "resnet110", "resnet116", "resnet200",
        "resnet14x2", "resnet38x2", "resnet110x2",
        "resnet8x4", "resnet14x4", "resnet20x4", "resnet26x4",
        "resnet32x4", "resnet38x4", "resnet44x4", "resnet56x4",
        "resnet110x4")},
    "wrn_40_1": (_P + "resnet_cifar", "resnet38"),
    "wrn_16_2": (_P + "resnet_cifar", "resnet14x2"),
    "wrn_40_2": (_P + "resnet_cifar", "resnet38x2"),
    "wrn_16_4": (_P + "resnet_cifar", "resnet14x4"),
    "wrn_40_4": (_P + "resnet_cifar", "resnet38x4"),
    # VGG
    **{f"vgg{d}": (_P + "vgg", f"vgg{d}_bn") for d in (8, 11, 13, 16, 19)},
    # CIFAR mobile / shuffle
    "MobileNetV2": (_P + "mobilenetv2", "mobile_half"),
    "MobileNetV2_1_0": (_P + "mobilenetv2", "mobile_half_double"),
    "ShuffleV1": (_P + "shufflenet_v1", "ShuffleV1"),
    "ShuffleV2": (_P + "shufflenet_v2", "ShuffleV2"),
    "ShuffleV2_1_5": (_P + "shufflenet_v2", "ShuffleV2_1_5"),
    # ImageNet ResNets
    "ResNet18": (_P + "resnet_imagenet", "resnet18"),
    "ResNet34": (_P + "resnet_imagenet", "resnet34"),
    "ResNet50": (_P + "resnet_imagenet", "resnet50"),
    "resnet101": (_P + "resnet_imagenet", "resnet101"),
    "resnet152": (_P + "resnet_imagenet", "resnet152"),
    "resnext50_32x4d": (_P + "resnet_imagenet", "resnext50_32x4d"),
    "ResNet10x2": (_P + "resnet_imagenet", "wide_resnet10_2"),
    "ResNet18x2": (_P + "resnet_imagenet", "wide_resnet18_2"),
    "ResNet34x2": (_P + "resnet_imagenet", "wide_resnet34_2"),
    "wrn_50_2": (_P + "resnet_imagenet", "wide_resnet50_2"),
    # ImageNet mobile / shuffle
    "MobileNetV2_Imagenet": (_P + "mobilenetv2_imagenet", "mobilenet_v2"),
    "ShuffleV2_Imagenet": (_P + "shufflenet_v2_imagenet",
                           "shufflenet_v2_x1_0"),
}
_EFFNETS = {f"effiB{i}": f"b{i}" for i in range(8)}
# ViT / DeiT, with the timm-flavoured aliases (architecturally the vit_*
# factories)
_VITS = {name: name for name in (
    "vit_base_patch16_224", "vit_tiny_patch16_224", "vit_small_patch16_224",
    "deit_base_patch16_224", "deit_tiny_patch16_224",
    "deit_small_patch16_224", "vit_tiny_patch16_384",
    "vit_base_patch16_384", "deit_base_patch16_384",
    "deit_tiny_patch16_384")}
_VITS.update({"vit_timm_base_patch16_224": "vit_base_patch16_224",
              "vit_timm_tiny_patch16_224": "vit_tiny_patch16_224"})
# the Mixture-of-Experts ViTs (models/vit_moe.py)
_MOES = ("vit_tiny_moe_patch16_224", "vit_small_moe_patch16_224")


def available_models():
    return sorted([*_REGISTRY, *_EFFNETS, *_VITS, *_MOES])


def create_model(name: str, num_classes: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 image_size: Optional[int] = None, **kw):
    """Build a registered backbone (moma_tpu/models/__init__.py
    counterpart).  A ViT (MoE ViTs too) needs `image_size`: its position
    embedding is sized from it.  Other keywords go to the model's
    constructor, as in moma_tpu (an EfficientNet's `stem_s2d`,
    `block_remat`)."""
    if name in _REGISTRY:
        module, attr = _REGISTRY[name]
        factory = getattr(importlib.import_module(module), attr)
        return factory(num_classes=num_classes, dtype=dtype,
                       generator=generator, **kw)
    if name in _EFFNETS:
        from moma_tpu_torch.models.efficientnet import EfficientNet

        return EfficientNet(_EFFNETS[name], num_classes=num_classes,
                            dtype=dtype, generator=generator, **kw)
    if name in _VITS or name in _MOES:
        if image_size is None:
            raise ValueError(f"{name} needs image_size: its position "
                             "embedding is sized from it")
        if name in _MOES:
            from moma_tpu_torch.models.vit_moe import moe_factory as factory
        else:
            from moma_tpu_torch.models.vit import vit_factory as factory
            name = _VITS[name]
        return factory(name, num_classes, image_size, dtype=dtype,
                       generator=generator, **kw)
    raise KeyError(f"unknown model '{name}'; known: {available_models()}")
