"""Histopathology train/eval augmentation stacks (device-side).

Counterpart of moma_tpu/data/histo_augment.py:
  train: [RandomResizedCrop(scale=(crop, 1)) if --image_resize] + hflip +
         RandAugment(rand-n2-m10-mstd0.5, fill=255*imagenet_mean) +
         normalize(imagenet stats); the flip rides RandAugment layer 1
  eval:  normalize
The crop's four draws come from the step's generator before
RandAugment's.
"""

from __future__ import annotations

import torch

from moma_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD,
                                         normalize, random_hflip,
                                         random_resized_crop)
from moma_tpu_torch.data.randaugment import parse_ra_config, rand_augment

RA_FILL = tuple(min(255, round(255 * m)) for m in IMAGENET_MEAN)


def make_histo_augment(cfg):
    image_size = cfg.data.image_size
    use_rrc = bool(cfg.data.image_resize)
    crop_lo = cfg.data.crop
    use_ra = cfg.data.aug_train == "RA"
    if use_ra:
        n_layers, magnitude, mstd, weights = parse_ra_config(
            cfg.data.ra_config)
    use_cmc = cfg.data.use_cmc

    def augment(images: torch.Tensor, generator: torch.Generator):
        x = images.float()
        if use_rrc:
            x = random_resized_crop(x, generator, image_size,
                                    scale=(crop_lo, 1.0))
        if use_ra:
            x = rand_augment(x, generator, num_layers=n_layers,
                             magnitude=magnitude, magnitude_std=mstd,
                             fill=RA_FILL, hflip=True,
                             choice_weights=weights, use_cmc=use_cmc)
        else:
            x = random_hflip(x, generator)
        return normalize(x / 255.0, IMAGENET_MEAN, IMAGENET_STD)

    return augment


def make_histo_eval(cfg):
    def eval_normalize(images: torch.Tensor) -> torch.Tensor:
        return normalize(images.float() / 255.0, IMAGENET_MEAN, IMAGENET_STD)

    return eval_normalize
