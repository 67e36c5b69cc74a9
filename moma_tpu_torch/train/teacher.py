"""Dataset and augmentation selection shared by the training entry points.

Counterpart of moma_tpu/train/teacher.py::build_datasets (:33-63) and
::augment_fns (:66-73).  Supervised teacher training (`run_teacher`) is not
ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from moma_tpu_torch.data.pipeline import synthetic_dataset


def build_datasets(cfg, synthetic: bool = False):
    d = cfg.data
    if synthetic or d.dataset == "synthetic":
        n_cls = cfg.model_s.n_cls
        train = synthetic_dataset(max(d.batch_size * 4, 256), d.image_size,
                                  n_cls, seed=cfg.run.seed)
        test = synthetic_dataset(max(d.batch_size * 2, 128), d.image_size,
                                 n_cls, seed=cfg.run.seed + 1)
        return train, test, test
    if d.dataset == "cifar100":
        raise NotImplementedError(
            "CIFAR-100 loading and its augment stack are not ported to "
            "moma_tpu_torch yet; pass --synthetic or a histo dataset")
    # file-backed histo datasets: the manifest / packed-cache reader
    from moma_tpu_torch.data.histo import load_histo_dataset

    return load_histo_dataset(d)


def augment_fns(cfg):
    d = cfg.data
    if d.dataset == "cifar100" or (d.dataset == "synthetic"
                                   and d.image_size == 32):
        raise NotImplementedError(
            "the CIFAR augment stack (random crop + flip) is not ported to "
            "moma_tpu_torch yet; use a histo dataset name (e.g. prostate_hv)")
    from moma_tpu_torch.data.histo_augment import (make_histo_augment,
                                                   make_histo_eval)

    return make_histo_augment(cfg), make_histo_eval(cfg)
