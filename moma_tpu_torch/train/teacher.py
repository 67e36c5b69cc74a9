"""Supervised teacher training, and the dataset and augmentation
selection the training entry points share.

Counterpart of moma_tpu/train/teacher.py: `build_datasets` (:33-63),
`augment_fns` (:66-73) and `run_teacher` (:76), the run of
scripts/run_vanilla.sh.  `run_teacher` trains one backbone of the port's
registry with the vanilla step (train/steps.py) under the shared epoch
loop (train/loop.py): run directory `<save_dir>/teacher_<run_name>` with
`ckpt/{latest,best_acc,best_f1}.pt` and their meta files, `stat.json`,
`scalars.jsonl`, TensorBoard events and `parameters.json`; `--pretrain`
(strict, or without the classifier under --not_strict / --pre_strict),
`--resume` (mid-epoch after a preemption save), SIGTERM / Ctrl-C
checkpoint and exit, the `--skip_validation` pre-flight, the NaN guard and
`--profile_dir`, and `--grad_accum`.  In a process group of several ranks
(core/mesh.py, `torch.distributed.run`) each rank trains on its rows of
the global batch with sync-BN statistics and averaged gradients: JAX's
global-batch step on N devices (with --grad_accum too: the Loader hands
each rank its share of every microbatch).  Its checkpoint holds the model under
`teacher`, which
models/pretrained.load_pretrained reads, so `--path_t` / `--tec_pre` /
`--std_pre` / `--pretrain` take a teacher run's `best_acc.pt`.
"""

from __future__ import annotations

import os

import torch

from moma_tpu_torch.core.checkpoint import CheckpointManager, StatsWriter
from moma_tpu_torch.core.config import Config, check_slice
from moma_tpu_torch.core.mesh import data_axis
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data import augment as aug
from moma_tpu_torch.data.cifar import cifar100_available, load_cifar100
from moma_tpu_torch.data.pipeline import Loader, synthetic_dataset
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import evaluate, resume_point, run_epochs
from moma_tpu_torch.train.state import TrainState, make_sgd
from moma_tpu_torch.train.steps import make_eval_step, make_vanilla_train_step


def build_datasets(cfg, synthetic: bool = False):
    """(train, val, test) ArrayDatasets: synthetic, CIFAR-100 (val = test,
    as in the reference) or a file-backed histo dataset."""
    d = cfg.data
    if d.fold_idx >= 0 and (synthetic
                            or d.dataset in ("synthetic", "cifar100")):
        # k-fold re-splits a manifest's train + val pool (data/histo.py);
        # synthetic and CIFAR have no manifests, so the flag would train
        # on the native splits under a fold's run name
        raise ValueError(
            f"--fold_idx applies to file-backed histo/imagefolder datasets, "
            f"not '{d.dataset}'")
    if synthetic or d.dataset == "synthetic":
        n_cls = cfg.model_s.n_cls
        train = synthetic_dataset(max(d.batch_size * 4, 256), d.image_size,
                                  n_cls, seed=cfg.run.seed)
        test = synthetic_dataset(max(d.batch_size * 2, 128), d.image_size,
                                 n_cls, seed=cfg.run.seed + 1)
        return train, test, test
    if d.dataset == "cifar100":
        if not cifar100_available(d.data_dir):
            raise FileNotFoundError(
                f"CIFAR-100 not found under {d.data_dir}; pass --synthetic "
                "for smoke runs")
        train, test = load_cifar100(d.data_dir)
        return train, test, test
    # file-backed histo datasets: the manifest / packed-cache reader
    from moma_tpu_torch.data.histo import load_histo_dataset

    return load_histo_dataset(d)


def augment_fns(cfg):
    """(train augment, eval normalize): the CIFAR stack for cifar100 and
    for the synthetic dataset at 32^2, else the histo / ImageNet one."""
    d = cfg.data
    if d.dataset == "cifar100" or (d.dataset == "synthetic"
                                   and d.image_size == 32):
        return aug.cifar_train_augment, aug.cifar_eval_normalize
    from moma_tpu_torch.data.histo_augment import (make_histo_augment,
                                                   make_histo_eval)

    return make_histo_augment(cfg), make_histo_eval(cfg)


def check_data_parallel_only(cfg: Config, what: str) -> None:
    """The JAX package's refusals of model parallelism and per-device BN
    outside --distill moma (train/teacher.py:82-107, student.py:70-96),
    with its messages; `what` is "teacher training" or "the comparison
    distillers"."""
    r = cfg.run
    teacher = what == "teacher training"
    if r.model_parallel > 1:
        raise ValueError(
            "--model_parallel > 1 is only wired for --distill moma (it "
            + ("shards the negative queue); teacher training is pure "
               "data-parallel" if teacher else
               "shards the negative queue over the 'model' axis); the "
               "comparison distillers are pure data-parallel"))
    if r.bn != "global":
        raise ValueError(
            f"--bn {r.bn} is only wired for --distill moma (shard_map "
            f"per-device execution); {what} "
            + ("runs jitted global-batch BN" if teacher else
               "run jitted global-batch BN"))
    if (r.sequence_parallel or r.teacher_parallel != "tensor"
            or r.pp_microbatch):
        raise ValueError(
            "--sequence_parallel / --teacher_parallel pipeline / "
            "--pp_microbatch apply to the MoMA cross-arch ViT teacher "
            "(--distill moma); "
            + ("teacher training has no model parallelism" if teacher else
               "the comparison distillers replicate their fixed teacher"))


def make_loaders(cfg: Config, synthetic: bool, device=None, extras=None,
                 datasets=None):
    """(train set, train, val and test loaders) of a run's `datasets`
    (build_datasets' by default), each loader yielding this rank's rows of
    the global batches (data/pipeline.py; the train loader's split follows
    --grad_accum).  The train loader takes --num_workers gather threads
    and, over a packed dataset on a CUDA `device`, copies its batches to
    the card from pinned memory."""
    train_ds, val_ds, test_ds = datasets or build_datasets(cfg, synthetic)
    ax = data_axis()
    shard = dict(rank=ax.rank, world=ax.world)
    return (train_ds,
            Loader(train_ds, cfg.data.batch_size, train=True,
                   seed=cfg.run.seed, extras=extras,
                   num_workers=cfg.data.num_workers, device=device,
                   grad_accum=cfg.run.grad_accum, **shard),
            Loader(val_ds, cfg.data.eval_batch_size, train=False, **shard),
            Loader(test_ds, cfg.data.eval_batch_size, train=False, **shard))


def build_teacher_state(cfg: Config, device: torch.device,
                        steps_per_epoch: int, seed: int):
    """The model from a seeded generator (a ViT sized from --image_size),
    --pretrain weights where given, and its SGD."""
    dtype = torch.bfloat16 if cfg.run.half_precision else None
    model = create_model(cfg.model_s.name, cfg.model_s.n_cls, dtype,
                         generator=torch.Generator().manual_seed(seed * 5),
                         image_size=cfg.data.image_size)
    if cfg.model_s.pretrain:
        load_pretrained(model, cfg.model_s.pretrain,
                        strict=cfg.model_s.strict)
    model = model.to(device, memory_format=torch.channels_last)
    o = cfg.optim
    return TrainState(
        model=model,
        optimizer=make_sgd(model.parameters(), momentum=o.momentum,
                           weight_decay=o.weight_decay, nesterov=o.nesterov,
                           grad_clip=o.grad_clip, trust_ratio=o.trust_ratio),
        schedule=lr_schedule(o.learning_rate, cfg.run.epochs,
                             steps_per_epoch, cosine=o.cosine,
                             decay_rate=o.lr_decay_rate,
                             decay_epochs=o.lr_decay_epochs,
                             warmup_epochs=o.warmup_epochs))


def teacher_full_state(state) -> dict:
    """The checkpointed state: the model with its BN buffers (under
    `teacher`), the optimizer's buffers and the step."""
    return {"teacher": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def load_teacher_full_state(state, saved: dict):
    state.model.load_state_dict(saved["teacher"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def run_teacher(cfg: Config, synthetic: bool = False, stop=None):
    """Supervised training run (train/teacher.py:76-305); returns (state,
    {'best_acc', 'best_f1', 'train', 'val', 'epochs', 'run_dir'}, plus
    'preempted' or 'nan_aborted' when the run stopped early).  `stop`: a
    GracefulStop-like guard in place of the SIGTERM / SIGINT one."""
    check_slice(cfg, supervised=True)
    check_data_parallel_only(cfg, "teacher training")
    device = resolve_device(cfg.run.device)
    run_dir = os.path.join(cfg.run.save_dir, f"teacher_{cfg.run_name}")
    os.makedirs(run_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                             map_location=device)
    n_cls = cfg.model_s.n_cls
    _, train_loader, val_loader, test_loader = make_loaders(cfg, synthetic,
                                                            device)
    state = build_teacher_state(cfg, device, len(train_loader), cfg.run.seed)

    train_aug, eval_norm = augment_fns(cfg)
    step_fn = make_vanilla_train_step(train_aug, cfg.run.grad_accum,
                                      cfg.run.remat)
    eval_step = make_eval_step(n_cls, normalize_fn=eval_norm)
    loaders = {"val": val_loader, "test": test_loader}

    def evaluate_fn(st, split):
        return evaluate(st.model, loaders[split], eval_step, device, n_cls)

    if cfg.run.preflight_eval:
        # reference --skip_validation (inverted store_false flag): the
        # loaded / pretrained model on the test split before training
        pre = evaluate_fn(state, "test")
        print(f"[pre-flight] model test acc {pre['acc']:.2f} "
              f"f1 {pre['f1']:.4f}", flush=True)

    saved, *start = resume_point(cfg, ckpt)
    if saved is not None:
        load_teacher_full_state(state, saved)
    n_params = sum(p.numel() for p in state.model.parameters())
    return run_epochs(
        cfg, state, epoch_step=lambda ep_start: step_fn,
        evaluate_fn=evaluate_fn, full_state=teacher_full_state,
        train_loader=train_loader, device=device, ckpt=ckpt,
        stats=StatsWriter(run_dir), run_dir=run_dir, start=start, stop=stop,
        test_loss=True, params={"num_params_M": n_params / 1e6},
        line="train loss")
