"""CLI: bulk checkpoint evaluation — the reference test.py capability.

Counterpart of moma_tpu/cli/test_eval.py (`build_parser` :34, `main`
:103): take run directories (a glob, a CSV of names, or every run under a
root), evaluate the student of each run's `ckpt/<tag>.pt` on the test
split, and write one stat.json with per-run accuracy, macro-F1, loss and
confusion matrix under the JAX package's keys.

    python -m moma_tpu_torch.cli.test_eval --runs './save/moma_*' \\
        --model effiB0 --dataset prostate_hv --data_dir ./data \\
        --image_size 512

    python -m moma_tpu_torch.cli.test_eval --runs '/tmp/save/moma_*' \\
        --synthetic --model effiB0 --n_cls 4 --image_size 64 --device cpu

`--num_per_class N` evaluates a per-class subset of N test images
(data/manifests.viz_subset, the reference's viz loader), and `--dump_attn
DIR` writes each run's CMO attention maps over the first batch to
`DIR/<run>_attn.npz` (moma/viz.py).  A ViT `--model` is built at
`--image_size`.

--device cuda (default) evaluates on the GPU and fails when there is none.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys

import numpy as np
import torch

from moma_tpu_torch.core.config import DATASET_NUM_CLASSES
from moma_tpu_torch.data import augment as aug
from moma_tpu_torch.data.manifests import viz_subset
from moma_tpu_torch.data.pipeline import (ArrayDataset, Loader,
                                          synthetic_dataset)
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.moma.viz import dump_attention_maps
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import evaluate
from moma_tpu_torch.train.steps import make_eval_step


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moma_tpu_torch test_eval")
    p.add_argument("--runs", type=str, default=None,
                   help="glob of run dirs containing ckpt/<tag>.pt")
    p.add_argument("--csv", type=str, default=None,
                   help="CSV with a 'name' column of run dirs (reference "
                        "test.py reads its model list from CSV, :187-220)")
    p.add_argument("--ckpt_tag", type=str, default="best_acc",
                   choices=["best_acc", "best_f1", "latest"])
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--out", type=str, default="./test_stat.json")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--models_dir", type=str, default=None,
                   help="reference-compat: root dir of runs; combine with "
                        "--csv_dir (test.py --models_dir)")
    p.add_argument("--csv_dir", type=str, default=None,
                   help="reference-compat alias for --csv; names resolve "
                        "under --models_dir when given (test.py --csv_dir)")
    p.add_argument("--n_cls", type=int, default=None,
                   help="override the dataset's class count (test.py --n_cls)")
    p.add_argument("--model_path", type=str, default=None,
                   help="reference-compat (test.py:62 'where to save'): "
                        "directory for the stat JSON; maps to "
                        "{model_path}/test_stat.json unless --out is given")
    p.add_argument("--num_per_class", type=int, default=None,
                   help="evaluate a per-class subset of N samples/class — "
                        "the reference's viz loader "
                        "(get_histo_dataloader_viz, histo_dataset.py:784-"
                        "842); combine with --dump_attn")
    p.add_argument("--dump_attn", type=str, default=None,
                   help="directory for attention-map .npz dumps (one per "
                        "MoMA run: atts_q/atts_k maps over one batch + "
                        "atts_queue over the saved queue rows — the "
                        "attn='self_viz' capability, "
                        "criterion_moco_att.py:171-197)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; an error if absent) "
                        "or cpu")
    # reference test.py reuses the full training parser (test.py:35-118):
    # its command lines carry training flags the eval never reads
    for flag in (
        "--aug_train", "--cosine", "--crop", "--dali", "--deterministic",
        "--dist-url", "--epochs", "--gpu_id", "--image_resize",
        "--learning_rate", "--lr_decay_epochs", "--lr_decay_rate",
        "--momentum", "--multiprocessing-distributed", "--pre_strict",
        "--pretrain", "--print_freq", "--seed", "--skip_test",
        "--skip_validation", "--trial", "--weight_decay",
    ):
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help="accepted for reference test.py compatibility, "
                            "ignored (training-parser residue)")
    return p


def _run_dirs(a) -> list:
    if a.csv:
        with open(a.csv) as f:
            rows = list(csv.DictReader(f))
        key = "name" if rows and "name" in rows[0] else list(rows[0])[0]
        run_dirs = [r[key] for r in rows]
        if a.models_dir:
            # reference semantics: CSV names under models_dir, or one
            # wildcard level in between ({models_dir}/*/{name}, test.py:206)
            resolved = []
            for d in run_dirs:
                direct = os.path.join(a.models_dir, d)
                if not os.path.isdir(direct):
                    hits = sorted(glob.glob(os.path.join(a.models_dir, "*",
                                                         d)))
                    if hits:
                        direct = hits[0]
                resolved.append(direct)
            run_dirs = resolved
        return run_dirs
    if a.models_dir:
        return sorted(d for d in glob.glob(os.path.join(a.models_dir, "*"))
                      if os.path.isdir(d))
    return sorted(glob.glob(a.runs)) if a.runs else []


def _checkpoint(run_dir: str, tag: str):
    """<run>/ckpt/<tag>.pt, or the one nested run's (<save_dir> given)."""
    path = os.path.join(run_dir, "ckpt", f"{tag}.pt")
    if os.path.isfile(path):
        return path
    nested = sorted(glob.glob(os.path.join(run_dir, "*", "ckpt",
                                           f"{tag}.pt")))
    if len(nested) == 1:
        return nested[0]
    if nested:
        print(f"skip {run_dir}: {len(nested)} nested runs have a {tag} "
              "checkpoint — point --runs at them directly")
    else:
        print(f"skip {run_dir}: no {tag} checkpoint")
    return None


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.csv_dir and not a.csv:
        a.csv = a.csv_dir
    if a.model_path and a.out == "./test_stat.json":
        os.makedirs(a.model_path, exist_ok=True)
        a.out = os.path.join(a.model_path, "test_stat.json")
    device = resolve_device(a.device)
    n_cls = a.n_cls or DATASET_NUM_CLASSES.get(a.dataset, 100)
    if a.synthetic:
        test_ds = synthetic_dataset(max(a.batch_size, 128), a.image_size,
                                    n_cls, 1)

        def norm(images):
            return aug.normalize(images, aug.CIFAR100_MEAN, aug.CIFAR100_STD)
    elif a.dataset == "cifar100":
        raise NotImplementedError(
            "CIFAR-100 loading is not ported to moma_tpu_torch yet; pass "
            "--synthetic or a histo dataset")
    else:
        from moma_tpu_torch.data.histo import load_histo_testset

        test_ds = load_histo_testset(a.dataset, a.data_dir, a.image_size)

        def norm(images):
            return aug.normalize(images, aug.IMAGENET_MEAN, aug.IMAGENET_STD)

    if a.num_per_class:
        picked = viz_subset(list(enumerate(test_ds.labels.tolist())),
                            per_class=a.num_per_class)
        idx = np.asarray(sorted(i for i, _ in picked))
        test_ds = ArrayDataset(test_ds.images[idx], test_ds.labels[idx])
        print(f"[viz] per-class subset: {len(test_ds)} samples "
              f"({a.num_per_class}/class)")
    run_dirs = _run_dirs(a)
    if not run_dirs:
        print("need --runs, --csv or --models_dir matching a run",
              file=sys.stderr)
        return {}
    loader = Loader(test_ds, a.batch_size, train=False)
    model = create_model(a.model, n_cls, image_size=a.image_size).to(
        device, memory_format=torch.channels_last)
    eval_step = make_eval_step(n_cls, normalize_fn=norm)
    results = {}
    for run_dir in run_dirs:
        path = _checkpoint(run_dir, a.ckpt_tag)
        if path is None:
            continue
        load_pretrained(model, path, strict=True)
        stats = evaluate(model, loader, eval_step, device, n_cls)
        name = os.path.basename(run_dir.rstrip("/"))
        results[name] = {
            "acc": stats["acc"], "f1": stats["f1"], "loss": stats["loss"],
            "n": stats["n"], "conf_mat": stats["conf_mat"],
        }
        print(f"{name}: acc {stats['acc']:.2f} f1 {stats['f1']:.4f}")
        if a.dump_attn:
            # the run dir owning parameters.json: <run>/ckpt/<tag>.pt
            owner = os.path.dirname(os.path.dirname(path))
            first = next(iter(loader))
            images = norm(torch.from_numpy(first["image"]).to(device))
            dump_attention_maps(path, owner, images, first["label"],
                                os.path.join(a.dump_attn, f"{name}_attn.npz"))
    with open(a.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {a.out}")
    return results


if __name__ == "__main__":
    main()
