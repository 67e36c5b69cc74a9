"""Histopathology dataset manifests — ports of dataset/histo_list.py's
preparers: glob the patch trees, parse labels from filenames/directories,
return (path, label) splits.  Root directories are parameters rather than
the reference's hardcoded relative paths.  The port's own copy of
moma_tpu/data/manifests.py (standard library and numpy only, same names).

Each preparer returns (train, valid, test) lists of (path, label).
"""

from __future__ import annotations

import glob
import os
from collections import Counter
from typing import List, Optional, Tuple

Pairs = List[Tuple[str, int]]

KATHER19_CLASSES = {
    "ADI": 0, "BACK": 1, "DEB": 2, "LYM": 3, "MUC": 4,
    "MUS": 5, "NORM": 6, "STR": 7, "TUM": 8,
}
# kather16 folders remapped onto the k19 label space, COMPLEX dropped
# (histo_list.py:150-168)
KATHER16_CLASSES = {
    "07_ADIPOSE": 0, "08_EMPTY": 1, "05_DEBRIS": 2, "04_LYMPHO": 3,
    "06_MUCOSA": 6, "02_STROMA": 7, "01_TUMOR": 8,
}
# prostate UBC test labels remapped (histo_list.py:171-181)
PROSTATE_UBC_MAP = {0: 0, 2: 1, 3: 2, 4: 3}


def _glob_label_suffix(pathname: str) -> Pairs:
    """Label = integer after the final '_' before the extension
    (prostate_hv convention, histo_list.py:62-67)."""
    files = sorted(glob.glob(pathname))
    return [(f, int(os.path.splitext(f)[0].split("_")[-1])) for f in files]


def prepare_prostate_hv(root: str) -> Tuple[Pairs, Pairs, Pairs]:
    """prostate_hv: ZT111/199/204 train, ZT76 val, patho_1 test
    (histo_list.py:61-84)."""
    tr = os.path.join(root, "patches_train_750_v0")
    va = os.path.join(root, "patches_validation_750_v0")
    te = os.path.join(root, "patches_test_750_v0")
    train = (
        _glob_label_suffix(f"{tr}/ZT111*/*.jpg")
        + _glob_label_suffix(f"{tr}/ZT199*/*.jpg")
        + _glob_label_suffix(f"{tr}/ZT204*/*.jpg")
    )
    valid = _glob_label_suffix(f"{va}/ZT76*/*.jpg")
    test = _glob_label_suffix(f"{te}/patho_1/*/*.jpg")
    return train, valid, test


def prepare_panda_512(root: str) -> Tuple[Pairs, Pairs, Pairs]:
    """PANDA 512 patches: label = int(parts[-3]) - 2; provider folders
    1,2,4,6 train / 3 valid / 5 test (histo_list.py:34-57)."""

    def load(pattern):
        files = sorted(glob.glob(pattern))
        return [(f, int(os.path.basename(f).split("_")[-3]) - 2) for f in files]

    sets = {i: load(os.path.join(root, f"{i}*", "*.png")) for i in range(1, 7)}
    train = sets[1] + sets[2] + sets[4] + sets[6]
    return train, sets[3], sets[5]


def prepare_kather19(root: str, nonorm: bool = False) -> Tuple[Pairs, Pairs, Pairs]:
    """K19: NCT-CRC-HE-100K[-NONORM] train, CRC-VAL-HE-7K val
    (histo_list.py:93-131); folder name -> class id."""
    train_dir = os.path.join(
        root, "NCT-CRC-HE-100K-NONORM" if nonorm else "NCT-CRC-HE-100K"
    )
    val_dir = os.path.join(root, "CRC-VAL-HE-7K")

    def load(d):
        out = []
        for f in sorted(glob.glob(os.path.join(d, "*", "*.tif"))):
            cls = os.path.basename(os.path.dirname(f))
            out.append((f, KATHER19_CLASSES[cls]))
        return out

    return load(train_dir), load(val_dir), []


def prepare_kather16_test(root: str) -> Pairs:
    out = []
    for f in sorted(glob.glob(os.path.join(root, "*", "*.tif"))):
        cls = os.path.basename(os.path.dirname(f))
        if cls in KATHER16_CLASSES:
            out.append((f, KATHER16_CLASSES[cls]))
    return out


def prepare_prostate_ubc_test(root: str) -> Pairs:
    out = []
    for f in sorted(glob.glob(os.path.join(root, "*", "*.jpg"))):
        raw = int(os.path.splitext(f)[0].split("_")[-1])
        out.append((f, PROSTATE_UBC_MAP[raw]))
    return out


def prepare_imagefolder(root: str, split_dirs=("train", "val")) -> Tuple[Pairs, Pairs, Pairs]:
    """torchvision ImageFolder layout (class-name subdirectories) — the
    dataset/imagenet.py capability: classes sorted alphabetically map to
    0..C-1; returns (train, val, val)."""

    def load(d):
        classes = sorted(
            e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e))
        )
        idx = {c: i for i, c in enumerate(classes)}
        out = []
        for c in classes:
            for f in sorted(glob.glob(os.path.join(d, c, "*"))):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".tif", ".bmp")):
                    out.append((f, idx[c]))
        return out

    train = load(os.path.join(root, split_dirs[0]))
    val_dir = os.path.join(root, split_dirs[1])
    val = load(val_dir) if os.path.isdir(val_dir) else []
    return train, val, val


PREPARERS = {
    "imagenet": prepare_imagefolder,
    "imagefolder": prepare_imagefolder,
    "prostate_hv": prepare_prostate_hv,
    "panda_512": prepare_panda_512,
    "kather19": lambda root: prepare_kather19(root, nonorm=False),
    "kather19_nonorm": lambda root: prepare_kather19(root, nonorm=True),
}

TEST_ONLY_PREPARERS = {
    "kather16": prepare_kather16_test,
    "prostate_ubc": prepare_prostate_ubc_test,
}


def class_histogram(pairs: Pairs) -> Counter:
    return Counter(lbl for _, lbl in pairs)


def viz_subset(pairs: Pairs, per_class: int = 8, seed: int = 0) -> Pairs:
    """Per-class visualization subset — the get_histo_dataloader_viz
    capability (dataset/histo_dataset.py:784-842): a few samples of each
    class for attention-map/feature visualization runs."""
    import numpy as np

    rng = np.random.RandomState(seed)
    by_class = {}
    for p, l in pairs:
        by_class.setdefault(l, []).append((p, l))
    out = []
    for l in sorted(by_class):
        items = by_class[l]
        idx = rng.permutation(len(items))[:per_class]
        out.extend(items[i] for i in idx)
    return out


def stratified_kfold(pairs: Pairs, fold_idx: int, n_folds: int = 5,
                     seed: int = 5) -> Tuple[Pairs, Pairs]:
    """(train, valid) for fold `fold_idx` with per-class round-robin
    assignment — the 5-fold capability (dataset/histo_dataset.py:848-1035,
    sklearn StratifiedKFold) without the sklearn dependency."""
    import numpy as np

    labels = np.asarray([l for _, l in pairs])
    rng = np.random.RandomState(seed)
    fold_of = np.empty(len(pairs), dtype=np.int64)
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        for j, i in enumerate(idx):
            fold_of[i] = j % n_folds
    train = [p for p, f in zip(pairs, fold_of) if f != fold_idx]
    valid = [p for p, f in zip(pairs, fold_of) if f == fold_idx]
    return train, valid
