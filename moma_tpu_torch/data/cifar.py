"""CIFAR-100 from the canonical on-disk pickle layout; nothing is
downloaded.

Counterpart of moma_tpu/data/cifar.py.  Expects
`<data_dir>/cifar-100-python/{train,test}` as the canonical tarball
unpacks them, and returns ArrayDatasets of NHWC uint8 images with the 100
fine labels; augmentation runs on the device (data/augment.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

from moma_tpu_torch.data.pipeline import ArrayDataset


def _load_split(data_dir: str, split: str) -> ArrayDataset:
    path = os.path.join(data_dir, "cifar-100-python", split)
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    images = (np.asarray(d["data"], dtype=np.uint8)
              .reshape(-1, 3, 32, 32)
              .transpose(0, 2, 3, 1)  # NCHW -> NHWC
              .copy())
    labels = np.asarray(d["fine_labels"], dtype=np.int32)
    return ArrayDataset(images, labels)


def cifar100_available(data_dir: str) -> bool:
    return os.path.exists(os.path.join(data_dir, "cifar-100-python", "train"))


def load_cifar100(data_dir: str) -> Tuple[ArrayDataset, ArrayDataset]:
    """(train, test): the reference has no CIFAR val split and validates
    on the test set."""
    return _load_split(data_dir, "train"), _load_split(data_dir, "test")


def write_cifar100(data_dir: str, n_train: int = 50000, n_test: int = 10000,
                   seed: int = 0) -> None:
    """Write seeded random images in the canonical pickle layout
    (`<data_dir>/cifar-100-python/{train,test}`: row-major NCHW uint8
    rows of 3072 bytes, 100 fine and 20 coarse labels), for tests and
    smoke runs where the real dataset is absent."""
    rs = np.random.RandomState(seed)
    root = os.path.join(data_dir, "cifar-100-python")
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        fine = rs.randint(0, 100, n)
        d = {"filenames": [f"{split}_{i}.png" for i in range(n)],
             "batch_label": f"{split} batch",
             "fine_labels": fine.tolist(),
             "coarse_labels": (fine // 5).tolist(),
             "data": rs.randint(0, 256, (n, 3 * 32 * 32), dtype=np.uint8)}
        with open(os.path.join(root, split), "wb") as f:
            pickle.dump(d, f, protocol=pickle.HIGHEST_PROTOCOL)
