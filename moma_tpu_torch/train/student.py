"""Distillation training run of the comparison distillers.

Counterpart of moma_tpu/train/student.py: `load_teacher_variables` (:44,
here `load_teacher`), `run_student` (:59) with the loader that draws the
CRD contrast indices per batch (`SampledLoader`, the JAX run's
`_SampledLoader`), and its epoch loop (:273, the shared
train/loop.run_epochs).  `--distill moma` goes to train/moma.run_moma, as
in the JAX package (:60-63).

The run builds the student and the teacher (`--path_t` / `--tec_pre`, a
teacher run's `best_acc.pt` for one), probes their feature shapes, builds
the method's aux modules and, for crd, its memory banks and the class-aware
sampler, then trains with `make_distill_train_step`.  Run directory
`<save_dir>/student_<run_name>` with `ckpt/{latest,best_acc,best_f1}.pt`
(the student, the aux modules, the optimizer, the step and the CRD banks:
--resume restores them all), `stat.json`, `scalars.jsonl`, TensorBoard
events and `parameters.json`.  simkd evaluates through its bottleneck and
the teacher's classifier (`make_simkd_eval_step`).

In a process group of several ranks (core/mesh.py, `torch.distributed.run
--nproc_per_node W`) each rank trains on its rows of the global batch
(train/distill.py: sync statistics, the coupled losses over the gathered
rows, averaged gradients), as run_teacher does: rank 0 writes the
checkpoints and stat files, every rank resumes from them (the CRD banks
too, equal on every rank), evaluation sums over the ranks and a SIGTERM
to one rank stops all of them at the agreed step (train/loop.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from moma_tpu_torch.core.checkpoint import CheckpointManager, StatsWriter
from moma_tpu_torch.core.config import Config, check_slice
from moma_tpu_torch.core.mesh import rank_rows
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data.sampler import InstanceSampler
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.distill import (Distiller, make_distill_train_step,
                                          make_simkd_eval_step, probe_shapes)
from moma_tpu_torch.train.loop import evaluate, resume_point, run_epochs
from moma_tpu_torch.train.state import DistillState, make_sgd
from moma_tpu_torch.train.steps import make_eval_step
from moma_tpu_torch.train.teacher import (augment_fns,
                                          check_data_parallel_only,
                                          make_loaders)


def load_teacher(cfg: Config, model_t: nn.Module) -> nn.Module:
    """The teacher's --path_t / --tec_pre weights, in place (a path or a
    preset tag; an unresolvable tag raises rather than distilling from an
    untrained teacher)."""
    if cfg.model_t.pretrain:
        load_pretrained(model_t, cfg.model_t.pretrain,
                        strict=cfg.model_t.strict)
    return model_t


class SampledLoader:
    """A train Loader whose batches also carry 'contrast_idx', the
    sampler's (B, K+1) draw for the batch's 'index' (int32).  Every rank
    of a group draws for the GLOBAL batch's rows, the one-process draw
    from the same seeded stream, and keeps its own rows of it
    (mesh.rank_rows, the Loader's split, --grad_accum aware)."""

    def __init__(self, inner, sampler: InstanceSampler):
        self.inner, self.sampler = inner, sampler
        self.batch_size = inner.batch_size
        inner.with_global_index = True

    def set_epoch(self, epoch: int):
        self.inner.set_epoch(epoch)

    def set_start_batch(self, start: int):
        self.inner.set_start_batch(start)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        inner = self.inner
        for batch in inner:
            draw = self.sampler.sample(batch.pop("global_index"))
            batch["contrast_idx"] = rank_rows(
                draw, inner.rank, inner.world,
                inner.grad_accum).astype(np.int32)
            yield batch


def build_distill_state(cfg: Config, device: torch.device,
                        steps_per_epoch: int, seed: int, n_data: int):
    """(DistillState, Distiller): student and teacher from seeded
    generators with --std_pre / --path_t weights, the method's aux modules
    and extra state, and one SGD over the student and the aux modules."""
    dtype = torch.bfloat16 if cfg.run.half_precision else None

    def gen(i):
        return torch.Generator().manual_seed(seed * 5 + i)

    student, teacher = (
        create_model(mc.name, cfg.model_s.n_cls, dtype, generator=gen(i),
                     image_size=cfg.data.image_size)
        for i, mc in enumerate((cfg.model_s, cfg.model_t)))
    if cfg.model_s.pretrain:
        load_pretrained(student, cfg.model_s.pretrain,
                        strict=cfg.model_s.strict)
    load_teacher(cfg, teacher)
    bs, size = cfg.data.batch_size, cfg.data.image_size
    distiller = Distiller(cfg, probe_shapes(student, size, bs)[0],
                          probe_shapes(teacher, size, bs)[0], n_data=n_data,
                          batch_size=bs, dtype=dtype)
    aux = distiller.init_aux(gen(2))
    fmt = torch.channels_last
    o = cfg.optim
    state = DistillState(
        student=student.to(device, memory_format=fmt),
        aux=aux.to(device, memory_format=fmt),
        teacher=teacher.to(device, memory_format=fmt).requires_grad_(False),
        optimizer=None, extra=distiller.init_extra(gen(3), device),
        schedule=lr_schedule(o.learning_rate, cfg.run.epochs,
                             steps_per_epoch, cosine=o.cosine,
                             decay_rate=o.lr_decay_rate,
                             decay_epochs=o.lr_decay_epochs,
                             warmup_epochs=o.warmup_epochs))
    state.teacher.eval()
    state.optimizer = make_sgd(
        state.trainable_params(), momentum=o.momentum,
        weight_decay=o.weight_decay, nesterov=o.nesterov,
        grad_clip=o.grad_clip, trust_ratio=o.trust_ratio)
    return state, distiller


def distill_full_state(state: DistillState) -> dict:
    """The checkpointed state: the student and the aux modules with their
    BN buffers, the optimizer's buffers, the step and the CRD memory (the
    frozen teacher is not saved, as in the JAX package)."""
    out = {"student": state.student.state_dict(),
           "aux": state.aux.state_dict(),
           "optimizer": state.optimizer.state_dict(), "step": state.step}
    if state.extra is not None:
        out["extra"] = state.extra.state_dict()
    return out


def load_distill_full_state(state: DistillState, saved: dict):
    state.student.load_state_dict(saved["student"])
    state.aux.load_state_dict(saved["aux"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    if state.extra is not None:
        state.extra.load_state_dict(saved["extra"])
    return state


def run_student(cfg: Config, synthetic: bool = False, stop=None):
    """Distillation run (train/student.py:59-271); returns (state,
    {'best_acc', 'best_f1', 'train', 'val', 'epochs', 'run_dir'}, plus
    'preempted' or 'nan_aborted' when the run stopped early).  `stop`: a
    GracefulStop-like guard in place of the SIGTERM / SIGINT one."""
    if cfg.distill.distill == "moma":
        from moma_tpu_torch.train.moma import run_moma

        return run_moma(cfg, synthetic=synthetic, stop=stop)
    check_slice(cfg)
    check_data_parallel_only(cfg, "the comparison distillers")
    for flag, on in (("--fast_teacher", cfg.moma.fast_teacher),
                     ("--fused_teacher on", cfg.moma.fused_teacher == "on")):
        if on:
            raise ValueError(f"{flag} applies to --distill moma; the "
                             "comparison distillers' teacher runs its own "
                             "eval-mode forward")
    device = resolve_device(cfg.run.device)
    run_dir = os.path.join(cfg.run.save_dir, f"student_{cfg.run_name}")
    os.makedirs(run_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                             map_location=device)
    n_cls = cfg.model_s.n_cls
    train_ds, train_loader, val_loader, test_loader = make_loaders(
        cfg, synthetic, device)
    state, distiller = build_distill_state(cfg, device, len(train_loader),
                                           cfg.run.seed, len(train_ds))
    if cfg.distill.distill == "crd":
        # class-aware negatives drawn on the host; the indices ride the
        # batch
        train_loader = SampledLoader(train_loader, InstanceSampler(
            train_ds.labels, k=cfg.moma.nce_k, mode=cfg.moma.mode,
            percent=cfg.data.percent, seed=cfg.run.seed))

    train_aug, eval_norm = augment_fns(cfg)
    step_fn = make_distill_train_step(distiller, train_aug,
                                      cfg.run.grad_accum, cfg.run.remat)
    loaders = {"val": val_loader, "test": test_loader}
    if cfg.distill.distill == "simkd":
        # no trained student classifier: eval routes the bottleneck's
        # pooled features through the reused teacher classifier
        eval_step = make_simkd_eval_step(distiller, state.teacher, n_cls,
                                         eval_norm)

        def evaluate_fn(st, split):
            model = nn.ModuleDict({"student": st.student,
                                   "simkd": st.aux["simkd"]})
            return evaluate(model, loaders[split], eval_step, device, n_cls)
    else:
        eval_step = make_eval_step(n_cls, normalize_fn=eval_norm)

        def evaluate_fn(st, split):
            return evaluate(st.student, loaders[split], eval_step, device,
                            n_cls)

    if cfg.run.preflight_eval:
        # reference --skip_validation (inverted store_false flag): the
        # loaded teacher on the test split before distilling from it
        pre = evaluate(state.teacher, test_loader,
                       make_eval_step(n_cls, normalize_fn=eval_norm), device,
                       n_cls)
        print(f"[pre-flight] teacher test acc {pre['acc']:.2f} "
              f"f1 {pre['f1']:.4f}", flush=True)

    saved, *start = resume_point(cfg, ckpt)
    if saved is not None:
        load_distill_full_state(state, saved)
    return run_epochs(
        cfg, state, epoch_step=lambda ep_start: step_fn,
        evaluate_fn=evaluate_fn, full_state=distill_full_state,
        train_loader=train_loader, device=device, ckpt=ckpt,
        stats=StatsWriter(run_dir), run_dir=run_dir, start=start, stop=stop)
