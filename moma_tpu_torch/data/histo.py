"""File-backed histopathology datasets: decode-once packed cache + mmap.

The port's own copy of moma_tpu/data/histo.py (same names, numpy and PIL
only): instead of decoding every JPEG each epoch on CPU workers, images are
decoded ONCE into a packed uint8 cache file (NHWC, fixed stored size), then
every epoch streams from the OS page cache.  Random augmentation happens on
the device (data/histo_augment.py), so the host's steady-state work is a
fancy-index gather.  The native C++ decoder and batch assembler of
moma_tpu/data/native are not ported: the pack is built with PIL on a
thread pool, and the cache files of the two packages are interchangeable
(same key, same layout).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from moma_tpu_torch.data.manifests import (
    PREPARERS,
    TEST_ONLY_PREPARERS,
    stratified_kfold,
)
from moma_tpu_torch.data.pipeline import ArrayDataset


def _decode_resize(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (size, size):
            # match the reference transform stacks: bilinear resize to the
            # working resolution (histo_dataset.py:207-239 Resize)
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


class PackedCache:
    """Packed uint8 NHWC cache: <name>.bin (memmap) + <name>.json meta."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, pairs, size) -> str:
        h = hashlib.sha1()
        for p, l in pairs:
            h.update(p.encode())
            h.update(str(l).encode())
        h.update(str(size).encode())
        return h.hexdigest()[:16]

    def build_or_open(self, pairs: List[Tuple[str, int]], size: int,
                      workers: int = 8) -> ArrayDataset:
        key = self._key(pairs, size)
        bin_path = os.path.join(self.cache_dir, f"pack_{key}.bin")
        meta_path = os.path.join(self.cache_dir, f"pack_{key}.json")
        n = len(pairs)
        labels = np.asarray([l for _, l in pairs], dtype=np.int32)
        if not (os.path.exists(bin_path) and os.path.exists(meta_path)):
            self._build(pairs, size, bin_path, meta_path, workers)
        images = np.memmap(bin_path, dtype=np.uint8, mode="r",
                           shape=(n, size, size, 3))
        return ArrayDataset(images, labels)

    def _build(self, pairs, size, bin_path, meta_path, workers):
        from concurrent.futures import ThreadPoolExecutor

        n = len(pairs)
        tmp = bin_path + ".tmp"
        mm = np.memmap(tmp, dtype=np.uint8, mode="w+",
                       shape=(n, size, size, 3))

        def work(i):
            mm[i] = _decode_resize(pairs[i][0], size)

        # decoded row by row straight into the memmap: a 50k x 512^2 split
        # is ~39 GB, far beyond host RAM
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(work, range(n)))
        mm.flush()
        del mm
        os.replace(tmp, bin_path)
        with open(meta_path, "w") as f:
            json.dump({"n": n, "size": size, "paths": [p for p, _ in pairs]}, f)


def load_histo_dataset(data_cfg) -> Tuple[ArrayDataset, ArrayDataset, ArrayDataset]:
    """(train, val, test) packed datasets for cfg.data.dataset."""
    name = data_cfg.dataset
    if name not in PREPARERS:
        raise KeyError(
            f"no manifest preparer for '{name}'; known: {sorted(PREPARERS)}"
        )
    train_pairs, val_pairs, test_pairs = PREPARERS[name](data_cfg.data_dir)
    if not train_pairs:
        raise FileNotFoundError(
            f"no files found for {name} under {data_cfg.data_dir}"
        )
    if getattr(data_cfg, "fold_idx", -1) >= 0:
        # stratified k-fold CV over the train+val pool — the reference's
        # 5-fold loader capability (dataset/histo_dataset.py:848-1035; its
        # fold manifests come from the absent histo_list_v1 module).  The
        # test split stays the dataset's native held-out set.  Same-fold
        # runs resolve identical splits across processes (seeded RNG).
        pool = train_pairs + val_pairs
        train_pairs, val_pairs = stratified_kfold(
            pool, data_cfg.fold_idx, data_cfg.n_folds
        )
    cache = PackedCache(os.path.join(data_cfg.data_dir, "_moma_pack"))
    size = data_cfg.image_size
    train = cache.build_or_open(train_pairs, size)
    val = cache.build_or_open(val_pairs, size) if val_pairs else train
    test = cache.build_or_open(test_pairs, size) if test_pairs else val
    return train, val, test


def load_histo_testset(name: str, root: str, image_size: int) -> ArrayDataset:
    """Test split for evaluation — the reference test.py's two modes:
    dedicated external test-only sets with label remapping (kather16,
    prostate_ubc; get_histo_testloader, histo_dataset.py:650-779), or a
    standard dataset's own held-out test list (test.py evaluates trained
    runs on the dataset's test manifest)."""
    if name in TEST_ONLY_PREPARERS:
        pairs = TEST_ONLY_PREPARERS[name](root)
    elif name in PREPARERS:
        _, _, pairs = PREPARERS[name](root)
        if not pairs:
            raise ValueError(f"dataset {name!r} has no test split under "
                             f"{root!r}")
    else:
        known = sorted(set(PREPARERS) | set(TEST_ONLY_PREPARERS))
        raise KeyError(f"unknown eval dataset {name!r} (known: {known})")
    cache = PackedCache(os.path.join(root, "_moma_pack"))
    return cache.build_or_open(pairs, image_size)
