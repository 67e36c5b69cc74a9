"""Host-side batch pipeline: arrays in RAM -> shuffled uint8 batches.

Counterpart of moma_tpu/data/pipeline.py (`ArrayDataset`,
`synthetic_dataset`, `Loader`), numpy-only, so the port's training path
needs nothing of the JAX package.  The same seeds give the same images,
labels and batch orders as moma_tpu.  The native C++ prefetcher that
moma_tpu uses for packed on-disk datasets is not ported: batches of a
memory-mapped dataset are gathered with numpy fancy indexing.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class ArrayDataset:
    """(images uint8 NHWC, labels) in RAM or memory-mapped."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if images.shape[0] != labels.shape[0] or images.ndim != 4:
            raise ValueError("ArrayDataset wants NHWC images and one label "
                             f"per image, got {images.shape} / {labels.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return self.images.shape[0]


def synthetic_dataset(n: int, image_size: int, n_cls: int,
                      seed: int = 0) -> ArrayDataset:
    """Deterministic fake data (identical to moma_tpu's for one seed)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, image_size, image_size, 3),
                         dtype=np.uint8)
    labels = rng.randint(0, n_cls, (n,)).astype(np.int32)
    return ArrayDataset(images, labels)


class Loader:
    """Epoch iterator: train=True reshuffles per epoch (seeded), drops
    the ragged tail and can start mid-epoch (`set_start_batch`);
    train=False is sequential, pads the last batch and marks valid rows in
    'mask'."""

    def __init__(self, dataset, batch_size: int, train: bool, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_batch(self, start: int):
        """Mid-epoch resume (train only): the next iteration starts at
        batch `start` of this epoch's seeded shuffle order; the skipped
        batches are index math, nothing is gathered.  Persistent until
        changed; train_one_epoch sets it every epoch (0 by default)."""
        self.start_batch = start

    def __len__(self):
        n = len(self.ds)
        if self.train:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        bs = self.batch_size
        if self.train:
            order = np.random.RandomState(
                (self.seed * 100003 + self.epoch) % (2 ** 31)).permutation(n)
            for i in range(self.start_batch, n // bs):
                idx = order[i * bs:(i + 1) * bs]
                yield {"image": self.ds.images[idx],
                       "label": self.ds.labels[idx]}
        else:
            for i in range(math.ceil(n / bs)):
                idx = np.arange(i * bs, min((i + 1) * bs, n))
                pad = bs - idx.shape[0]
                mask = np.ones(bs, dtype=bool)
                if pad:
                    mask[idx.shape[0]:] = False
                    idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
                yield {"image": self.ds.images[idx],
                       "label": self.ds.labels[idx], "mask": mask}
