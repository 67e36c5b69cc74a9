"""MoMA student training — the paper's method, one step at a time.

Counterpart of moma_tpu/train/moma.py with global-batch BN on one device,
every memory variant (`--mem MoCo | MoCoAtt | MoCoST | MoCoSSTT`),
attention mode and head, for a same-arch teacher (the momentum encoder)
and, in cross-arch CMO_EmaTec mode, a teacher of another architecture (a
ViT or another EfficientNet).  The same-arch step keeps the JAX step's
order (train/moma.py:1-28), with the state updated in place:

  1. teacher KL forward on the PRE-EMA teacher; BN in train mode
     (kl_train_bn, its running statistics updated here first) or on
     running statistics (each epoch's first batch under 'exact');
  2. EMA: teacher <- alpha*teacher + (1-alpha)*student, and for the mlp
     heads embed_t <- EMA of embed_s, both from the pre-step student;
  3. key forward through the post-EMA teacher with train-mode BN on the
     Shuffle-BN permuted batch (batch['shuffle_perm'] when given), whose
     BN statistics chain from step 1; embed_t in eval mode; unshuffle;
  4. student forward; q = embed_s(pooled); then by memory variant
     (train/moma.py:536-634):
       MoCo      attn 'self' only: atts_q(q), atts_k(k), and atts_queue on
                 the keys ENTERING the queue;
       MoCoAtt   `step_moco_att` on the raw (q, k, keys): the attention of
                 the mode acts inside, over up to 2B+K tokens, with
                 gradients through every token;
       MoCoST    dual banks memory_s / memory_t (same-arch: both take the
                 momentum encoder's keys), loss on the first logit set;
       MoCoSSTT  as MoCoST plus a second augmented view through the
                 student (its BN running statistics discarded): four
                 logit sets, loss_kd their mean;
  5. logits from the PRE-update memory, then the enqueue;
  6. loss = c*CE + d*KL(T) + beta*loss_kd; SGD on the student, embed_s and
     the attention set (modules without gradient still decay, as in the
     optax chain).

Every train-mode BatchNorm goes through the channel-sum kernels, its
backward through the grad-sum kernel, the augmentation through the
RandAugment layer kernel, and attention over more than 2048 tokens through
the flash-attention kernels (on a CUDA device).  With `--fused_teacher on`
both gradient-free teacher forwards (steps 1 and 3) run the recompute-style
fused forward of ops/fused_effnet.py and its three kernels in place of the
module forward: the same function by another route
(train/moma.py:206-212, :321-339, :428-445), in the teacher's compute dtype.
With `--fast_teacher` the KL logits are the key forward's (unshuffled), so
a step runs one teacher forward (train/moma.py:192-197, :475-480).

Cross-arch (`cross_arch=True`, train/moma.py:294-700; `build_state`
detects it as run_moma does, :1209-1218: the two backbones' parameter
names differ) changes three things.  The KL forward runs on the fixed
teacher, always in eval mode (`kl_teacher_bn` does not apply, :340-348).
The momentum encoder is `state.ema`, an EMA copy of the student with its
own BN statistics: the EMA goes into it (:374-377), the key forward runs
through it in train mode (:417-426; the step's second train-mode forward
through the channel-sum kernels), and its key head is embed_ema, EMA'd
from embed_s for the mlp heads.  For MoCoST / MoCoSSTT the teacher keys
of `memory_t` are embed_t in eval mode over the fixed teacher's pooled
features (:488-495, :559-561).  `--fast_teacher` and `--fused_teacher on`
do nothing there (:197-198, :206-212), and build_state says so.

`run_moma` is the run around the step (train/moma.py:1163-1640): the run
directory `<save_dir>/moma_<run_name>` with `ckpt/{latest,best_acc,
best_f1}.pt` (core/checkpoint.py; `latest` every epoch, the best ones on a
new best), `stat.json`, `scalars.jsonl`, TensorBoard events and
`parameters.json`; `--resume` from `latest` (mid-epoch after a preemption
save, with the best-metric thresholds read back from their meta files);
SIGTERM / Ctrl-C checkpoint and exit (core/preempt.py); a non-finite loss
stops the run with `latest` kept; `--std_pre` / `--tec_pre`
(models/pretrained.py); the teacher pre-flight eval (`--skip_validation`)
and a torch.profiler trace of the first epoch (`--profile_dir`).

Not ported yet (ROADMAP.md): --remat.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
import warnings
from typing import Callable, Optional

import torch
from torch import nn

from moma_tpu_torch.core.checkpoint import CheckpointManager, StatsWriter
from moma_tpu_torch.core.config import Config, check_slice
from moma_tpu_torch.core.preempt import GracefulStop
from moma_tpu_torch.core.profiling import trace
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.data.pipeline import Loader
from moma_tpu_torch.losses import functional as F
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.moma.cmo import CMOHeads
from moma_tpu_torch.moma.queue import (QueueState, contrast_ce,
                                       random_memory, step_moco,
                                       step_moco_att, step_moco_sstt,
                                       step_moco_st)
from moma_tpu_torch.ops import fused_effnet
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import (NonFiniteLossError, evaluate,
                                       train_one_epoch)
from moma_tpu_torch.train.state import MomaState, make_sgd
from moma_tpu_torch.train.steps import make_eval_step
from moma_tpu_torch.train.teacher import augment_fns, build_datasets


@torch.no_grad()
def ema_update(ema: nn.Module, src: nn.Module, alpha: float) -> None:
    """p_ema <- alpha*p_ema + (1-alpha)*p over parameters (not buffers),
    in place (train/moma.py:88-96)."""
    pe = list(ema.parameters())
    ps = [p.to(q.dtype) for p, q in zip(src.parameters(), pe)]
    scaled = torch._foreach_mul(ps, 1.0 - alpha)
    torch._foreach_mul_(pe, alpha)
    torch._foreach_add_(pe, scaled)


@contextlib.contextmanager
def _buffers_restored(*modules: nn.Module):
    """Put the modules' buffers (BN running statistics) back on exit: a
    forward inside updates them in place, and the second view of MoCoSSTT
    discards its updates (train/moma.py:573)."""
    saved = [(b, b.clone()) for m in modules for b in m.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, old in saved:
                b.copy_(old)


def module_forward(model, images, train: bool):
    """(pooled, logits) of a backbone's module forward in train or eval
    mode; BN running statistics updated in place when `train`."""
    model.train(train)
    feats, logits = model(images)
    return feats[-1], logits


def is_cross_arch(student: nn.Module, teacher: nn.Module) -> bool:
    """EmaTec mode: the backbones' parameter trees differ in names, not
    only in shapes (train/moma.py:1209-1218)."""
    return ([n for n, _ in student.named_parameters()]
            != [n for n, _ in teacher.named_parameters()])


def make_teacher_forward(cfg: Config):
    """forward(teacher, images, train) -> (pooled, logits) for the two
    gradient-free teacher passes, BN running statistics updated in place
    when `train`: the module forward, or with `--fused_teacher on` the fused
    forward in the teacher's compute dtype.  Its parameters are views of the
    teacher module, taken once per module (the in-place EMA shows through
    them).  The flag with a teacher that is no EfficientNet raises."""
    if cfg.moma.fused_teacher == "on":
        if not cfg.model_t.name.startswith("effiB"):
            raise ValueError("--fused_teacher on needs an EfficientNet "
                             f"teacher, got {cfg.model_t.name!r}")
        variant = "b" + cfg.model_t.name[len("effiB"):]
        views = {}

        def forward(teacher, images, train: bool):
            # a module moved or cast since has new storage: take new views
            key = (id(teacher), teacher.stem_conv.weight.data_ptr())
            if views.get("of") != key:
                views["of"] = key
                views["params"], views["specs"] = (
                    fused_effnet.extract_params(teacher, variant))
            params, specs = views["params"], views["specs"]
            pooled, logits, collected = fused_effnet.fused_forward(
                params, specs, images, train=train,
                compute_dtype=teacher.stem_conv.dtype or torch.float32)
            if train:
                fused_effnet.updated_batch_stats(params, specs, collected)
            return pooled, logits
    else:
        forward = module_forward
    return forward


def make_moma_train_step(cfg: Config, augment_fn: Optional[Callable],
                         kl_train_bn_override: Optional[bool] = None,
                         cross_arch: bool = False):
    """step(state, batch, generator) -> (state, metrics).

    batch: {'image': NHWC on the run's device, 'label': (B,) int, optional
    'shuffle_perm': (B,) int}.  `generator` (CPU) drives the augmentation
    and the Shuffle-BN permutation.  `cross_arch`: the EmaTec step, for a
    state with its EMA copy (`state.ema`, build_state)."""
    check_slice(cfg)
    c, dv, b = cfg.distill.cls, cfg.distill.div, cfg.distill.beta
    kd_T = cfg.distill.kd_T
    alpha = cfg.moma.alpha
    nce_t = cfg.moma.nce_t
    mem = cfg.moma.mem
    # self_viz trains exactly as 'self' (same module set; cmo.py ATTN_SETS)
    attn = "self" if cfg.moma.attn == "self_viz" else cfg.moma.attn
    # embed_t is EMA-tracked for the mlp heads only (train/moma.py:382-389)
    ema_head = cfg.moma.head in ("mlp", "mlp_byol")
    shuffle_bn = cfg.moma.shuffle_bn
    if cross_arch:
        # the KL teacher is not the momentum encoder: no forward to share,
        # and the fused forward's EfficientNet teacher path is off
        # (build_state says so)
        fast_teacher = False
        teacher_forward = module_forward
    else:
        fast_teacher = cfg.moma.fast_teacher
        teacher_forward = make_teacher_forward(cfg)
    kl_bn_mode = cfg.moma.kl_teacher_bn
    if kl_bn_mode not in ("train", "eval", "exact"):
        raise ValueError(f"unknown kl_teacher_bn {kl_bn_mode!r}")
    if kl_train_bn_override is not None:
        kl_train_bn = bool(kl_train_bn_override)
    elif kl_bn_mode == "exact":
        warnings.warn(
            "kl_teacher_bn='exact' on a bare make_moma_train_step builds the "
            "steady-state (train-BN) step only; the first-batch eval-BN step "
            "needs kl_train_bn_override=False, dispatched on each epoch's "
            "first batch (as run_moma does)", stacklevel=2)
        kl_train_bn = True
    else:
        kl_train_bn = kl_bn_mode == "train"

    def step(state: MomaState, batch, generator: torch.Generator):
        student, teacher, heads = state.student, state.teacher, state.heads
        if cross_arch != (state.ema is not None):
            raise ValueError(
                f"a {'cross' if cross_arch else 'same'}-arch step for a "
                f"state {'without' if cross_arch else 'with'} an EMA copy")
        # the momentum encoder and its key head
        momentum = state.ema if cross_arch else teacher
        key_head = heads.embed_ema if cross_arch else heads.embed_t
        images = batch["image"]
        if augment_fn is not None:
            images = augment_fn(images, generator)
        labels = batch["label"].long()
        B = images.shape[0]

        # 1. KL forward, pre-EMA teacher (none with fast_teacher: step 3's
        # logits stand in); cross-arch: the fixed teacher in eval mode
        if not fast_teacher:
            with torch.no_grad():
                pooled_t, logit_t = teacher_forward(
                    teacher, images, kl_train_bn and not cross_arch)

        # 2. EMA from the pre-step student
        ema_update(momentum, student, alpha)
        if ema_head:
            ema_update(key_head, heads.embed_s, alpha)

        # 3. keys through the post-EMA teacher, BN in train mode
        with torch.no_grad():
            if shuffle_bn:
                if "shuffle_perm" in batch:
                    perm = batch["shuffle_perm"].to(images.device).long()
                else:
                    perm = torch.randperm(B, generator=generator).to(
                        images.device)
                inv = torch.argsort(perm)
                key_images = images[perm]
            else:
                key_images = images
            pooled_key, logit_key = teacher_forward(momentum, key_images,
                                                    True)
            key_head.eval()  # the momentum head runs in eval mode
            k_emb = key_head(pooled_key)
            if shuffle_bn:
                k_emb = k_emb[inv]
                logit_key = logit_key[inv]
            if fast_teacher:
                # post-EMA teacher, train-mode BN: a documented deviation
                logit_t = logit_key
            kt_emb = None
            if cross_arch and mem in ("MoCoST", "MoCoSSTT"):
                # the fixed teacher's keys for memory_t
                heads.embed_t.eval()
                kt_emb = heads.embed_t(pooled_t)
        # MoCoSSTT's second view, drawn after the permutation as in JAX
        images2 = None
        if mem == "MoCoSSTT":
            images2 = (augment_fn(batch["image"], generator)
                       if augment_fn is not None else images)

        # 4-6. student, contrast against the pre-update queue, SGD
        student.train()
        heads.embed_s.train()
        feat_s, logit_s = student(images)
        loss_cls = F.cross_entropy(logit_s, labels)
        loss_div = F.kd_kl(logit_s, logit_t, kd_T)
        q = heads.embed_s(feat_s[-1])
        fns = heads.attn_fns()
        self_attn = attn == "self" and bool(fns)
        if mem == "MoCoAtt":
            logits, new_queue = step_moco_att(state.queue, q, k_emb, k_emb,
                                              nce_t, attn, fns)
            logits_list = [logits]
        elif mem in ("MoCoST", "MoCoSSTT"):
            # same-arch: the momentum encoder's keys fill both banks;
            # cross-arch: the fixed teacher's fill memory_t.  The
            # teacher-side keys stay the raw ones (train/moma.py:560-561)
            q_in, k_in = q, k_emb
            kt_in = kt_emb if kt_emb is not None else k_emb
            if self_attn:
                q_in = fns["atts_q"](q_in)
                with torch.no_grad():
                    k_in = fns["atts_k"](k_in)
            if mem == "MoCoSSTT":
                with _buffers_restored(student, heads.embed_s):
                    feat_s2, _ = student(images2)
                    qt_in = heads.embed_s(feat_s2[-1])
                if self_attn:
                    qt_in = fns["atts_q"](qt_in)
                *logits_list, new_queue = step_moco_sstt(
                    state.queue, q_in, k_in, qt_in, kt_in, k_in, kt_in, nce_t)
            else:
                logits_ss, _, new_queue = step_moco_st(
                    state.queue, q_in, k_in, kt_in, k_in, kt_in, nce_t)
                # the loss takes the first logit set only
                logits_list = [logits_ss]
        else:  # MoCo
            q_in, k_in, keys_in = q, k_emb, k_emb
            if self_attn:
                # atts_queue transforms the keys ENTERING the queue, not
                # the queue memory
                q_in = fns["atts_q"](q_in)
                with torch.no_grad():
                    k_in = fns["atts_k"](k_emb)
                    keys_in = fns["atts_queue"](k_emb)
            logits, new_queue = step_moco(state.queue, q_in, k_in, keys_in,
                                          nce_t)
            logits_list = [logits]
        loss_kd = sum(contrast_ce(lg) for lg in logits_list) / len(
            logits_list)
        total = c * loss_cls + dv * loss_div + b * loss_kd

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        total.backward()
        for group in opt.param_groups:
            group["lr"] = state.schedule(state.step)
            for p in group["params"]:
                if p.grad is None:  # unused modules: decay still applies
                    p.grad = torch.zeros_like(p)
        opt.step()
        state.queue = new_queue
        state.step += 1

        with torch.no_grad():
            k5 = min(5, logit_s.shape[-1])
            metrics = {
                "loss": total.detach(),
                "loss_cls": loss_cls.detach(),
                "loss_div": loss_div.detach(),
                "loss_kd": loss_kd.detach(),
                "acc1": (logit_s.argmax(-1) == labels).float().mean() * 100.0,
                "acc5": (logit_s.topk(k5, -1).indices == labels[:, None])
                .any(-1).float().mean() * 100.0,
                "queue_ptr": new_queue.ptr,
            }
        return state, metrics

    return step


def build_state(cfg: Config, device: torch.device, steps_per_epoch: int,
                seed: int) -> MomaState:
    """Student, teacher, CMO heads, queue and SGD from seeded generators;
    the student and teacher then take --std_pre / --tec_pre weights where
    given (load_pretrained; an unresolvable tag raises).  Backbones whose
    parameter names differ make a cross-arch (EmaTec) state: its momentum
    encoder `ema` is a distinct copy of the student, its heads gain
    embed_ema."""
    dtype = torch.bfloat16 if cfg.run.half_precision else None
    n_cls = cfg.model_s.n_cls

    def gen(i):
        return torch.Generator().manual_seed(seed * 5 + i)

    student, teacher = (
        create_model(mc.name, n_cls, dtype, generator=gen(i),
                     image_size=cfg.data.image_size)
        for i, mc in enumerate((cfg.model_s, cfg.model_t)))
    for model, mc in ((student, cfg.model_s), (teacher, cfg.model_t)):
        if mc.pretrain:
            load_pretrained(model, mc.pretrain, strict=mc.strict)
    cross_arch = is_cross_arch(student, teacher)
    if cross_arch:
        print(f"[moma] cross-arch ({cfg.model_t.name} teacher -> "
              f"{cfg.model_s.name} student): EmaTec momentum-encoder mode",
              flush=True)
        for flag, on in (("--fast_teacher", cfg.moma.fast_teacher),
                         ("--fused_teacher on",
                          cfg.moma.fused_teacher == "on")):
            if on:
                print(f"[moma] {flag} does nothing in EmaTec mode: the "
                      "fixed teacher runs its own module forward",
                      flush=True)
    # the 'None' head passes the pooled features through
    feat_dim = (cfg.moma.feat_dim if cfg.moma.head != "None"
                else student.feat_dim)
    heads = CMOHeads(cfg.moma.head, cfg.moma.attn, feat_dim,
                     s_dim=student.feat_dim, t_dim=teacher.feat_dim,
                     generator=gen(2), include_ema=cross_arch)
    ema = copy.deepcopy(student) if cross_arch else None
    student = student.to(device, memory_format=torch.channels_last)
    teacher = teacher.to(device, memory_format=torch.channels_last)
    heads = heads.to(device)
    teacher.requires_grad_(False)
    heads.embed_t.requires_grad_(False)
    if cross_arch:
        # the fixed teacher never leaves eval mode
        teacher.eval()
        ema = ema.to(device, memory_format=torch.channels_last)
        ema.requires_grad_(False)
        heads.embed_ema.requires_grad_(False)
    banks = (("memory_s", "memory_t")
             if cfg.moma.mem in ("MoCoST", "MoCoSSTT") else ("memory",))
    g_queue = gen(3)
    queue = QueueState({name: random_memory(cfg.moma.nce_k, feat_dim,
                                            g_queue, device)
                        for name in banks})
    state = MomaState(student=student, teacher=teacher, heads=heads,
                      queue=queue, optimizer=None, ema=ema,
                      schedule=lr_schedule(
                          cfg.optim.learning_rate, cfg.run.epochs,
                          steps_per_epoch, cosine=cfg.optim.cosine,
                          decay_rate=cfg.optim.lr_decay_rate,
                          decay_epochs=cfg.optim.lr_decay_epochs,
                          warmup_epochs=cfg.optim.warmup_epochs))
    state.optimizer = make_sgd(
        state.trainable_params(), momentum=cfg.optim.momentum,
        weight_decay=cfg.optim.weight_decay, nesterov=cfg.optim.nesterov,
        grad_clip=cfg.optim.grad_clip, trust_ratio=cfg.optim.trust_ratio)
    return state


def full_state(state: MomaState) -> dict:
    """The checkpointable state: both backbones with their BN buffers, in
    cross-arch runs the EMA copy with its own (train/moma.py:1468-1481),
    the heads, every queue bank and its pointer, the optimizer's buffers
    and the step."""
    out = {"student": state.student.state_dict(),
           "teacher": state.teacher.state_dict(),
           "heads": state.heads.state_dict(),
           "queue": {"memory": dict(state.queue.memory),
                     "ptr": state.queue.ptr},
           "optimizer": state.optimizer.state_dict(),
           "step": state.step}
    if state.ema is not None:
        out["ema"] = state.ema.state_dict()
    return out


def load_full_state(state: MomaState, saved: dict) -> MomaState:
    """Copy a `full_state` dict into `state` in place (the modules keep
    their storage, so views taken of them stay valid).  A cross-arch
    checkpoint without the EMA copy restores the rest and warns: the
    momentum encoder keeps the copy made at start (train/moma.py:
    1485-1500)."""
    if state.ema is not None:
        if "ema" in saved:
            state.ema.load_state_dict(saved["ema"])
        else:
            print("[resume] WARNING: old cross-arch checkpoint without the "
                  "EMA copy — the EmaTec momentum encoder restarts from "
                  "the copy of the student made at start", flush=True)
    state.student.load_state_dict(saved["student"])
    state.teacher.load_state_dict(saved["teacher"])
    state.heads.load_state_dict(saved["heads"])
    mem = saved["queue"]["memory"]
    if set(mem) != set(state.queue.memory):
        raise ValueError(f"checkpoint queue banks {sorted(mem)} differ from "
                         f"the run's {sorted(state.queue.memory)}")
    state.queue = QueueState(dict(mem), int(saved["queue"]["ptr"]))
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def run_moma(cfg: Config, synthetic: bool = False, stop=None):
    """MoMA student training run (train/moma.py:1163-1535); returns
    (state, {'best_acc', 'best_f1', 'train', 'val', 'epochs', 'run_dir'},
    plus 'preempted' or 'nan_aborted' when the run stopped early).

    `stop` is a GracefulStop-like guard to use in place of the one that
    run_moma installs for SIGTERM / SIGINT."""
    check_slice(cfg)
    device = resolve_device(cfg.run.device)
    run_dir = os.path.join(cfg.run.save_dir, f"moma_{cfg.run_name}")
    os.makedirs(run_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                             map_location=device)
    n_cls = cfg.model_s.n_cls
    train_ds, val_ds, test_ds = build_datasets(cfg, synthetic)
    train_loader = Loader(train_ds, cfg.data.batch_size, train=True,
                          seed=cfg.run.seed)
    val_loader = Loader(val_ds, cfg.data.eval_batch_size, train=False)
    test_loader = Loader(test_ds, cfg.data.eval_batch_size, train=False)
    state = build_state(cfg, device, len(train_loader), cfg.run.seed)

    train_aug, eval_norm = augment_fns(cfg)
    cross_arch = state.ema is not None
    if cfg.moma.kl_teacher_bn == "exact":
        step_fn = tuple(
            make_moma_train_step(cfg, train_aug, kl_train_bn_override=flag,
                                 cross_arch=cross_arch)
            for flag in (False, True))
    else:
        step_fn = make_moma_train_step(cfg, train_aug, cross_arch=cross_arch)
    eval_step = make_eval_step(n_cls, normalize_fn=eval_norm)

    if cfg.run.preflight_eval:
        # reference --skip_validation (inverted store_false flag): the
        # loaded teacher on the test split before training
        pre = evaluate(state.teacher, test_loader, eval_step, device, n_cls)
        print(f"[pre-flight] teacher test acc {pre['acc']:.2f} "
              f"f1 {pre['f1']:.4f}", flush=True)

    best_acc, best_f1 = -1.0, -1.0
    start_epoch, resume_step = 1, 0
    if cfg.run.resume and ckpt.exists("latest"):
        load_full_state(state, ckpt.restore("latest"))
        meta = ckpt.meta("latest") or {}
        start_epoch = int(meta.get("epoch", 0)) + 1
        # exact mid-epoch resume point of a preemption save
        resume_step = int(meta.get("resume_step", 0))
        # the best-metric thresholds survive the restart (else the first
        # epoch after it would overwrite the real best checkpoints)
        m = ckpt.meta("best_acc")
        if m is not None:
            best_acc = float(m.get("val_acc", -1.0))
        m = ckpt.meta("best_f1")
        if m is not None:
            best_f1 = float(m.get("val_f1", -1.0))
        print(f"[resume] from epoch {start_epoch}"
              + (f" step {resume_step}" if resume_step else "")
              + f" (best_acc={best_acc:.2f}, best_f1={best_f1:.4f})",
              flush=True)

    stats = StatsWriter(run_dir)
    guard = stop if stop is not None else GracefulStop()
    try:
        if stop is None:
            guard.__enter__()
        return _epoch_loop_moma(
            cfg, state, stats, ckpt, guard, step_fn, eval_step,
            train_loader, val_loader, test_loader, device, n_cls,
            start_epoch, resume_step, best_acc, best_f1, run_dir)
    finally:
        # the prior handlers come back, so a later SIGTERM in this process
        # is not swallowed by a dead flag
        if stop is None:
            guard.__exit__()
        stats.close()


def _epoch_loop_moma(cfg, state, stats, ckpt, stop, step_fn, eval_step,
                     train_loader, val_loader, test_loader, device, n_cls,
                     start_epoch, resume_step, best_acc, best_f1, run_dir):
    t_start = time.time()
    history = []
    tr = val = None

    def result(**extra):
        return state, {"best_acc": best_acc, "best_f1": best_f1, "train": tr,
                       "val": val, "epochs": history, "run_dir": run_dir,
                       **extra}

    for epoch in range(start_epoch, cfg.run.epochs + 1):
        ep_start = resume_step if epoch == start_epoch else 0
        if isinstance(step_fn, tuple):
            # 'exact': eval-BN KL forward on the epoch's first batch (the
            # per-epoch model_t.eval() reset), train-BN after.  A mid-epoch
            # resume already ran the epoch's first batch before the
            # preemption, so it takes the train-BN step throughout.
            first_fn, rest_fn = step_fn
            seen = [0 if ep_start == 0 else 1]

            def epoch_step(s, b, g):
                fn = first_fn if seen[0] == 0 else rest_fn
                seen[0] += 1
                return fn(s, b, g)
        else:
            epoch_step = step_fn
        ctx = (trace(cfg.run.profile_dir)
               if cfg.run.profile_dir and epoch == start_epoch
               else contextlib.nullcontext())
        try:
            with ctx:
                state, tr = train_one_epoch(
                    state, train_loader, epoch_step, device, epoch,
                    cfg.run.seed, print_freq=cfg.run.print_freq,
                    log_fn=stats.scalar, stop=stop, start_step=ep_start)
        except NonFiniteLossError as e:
            # 'latest' (the end of the last finite epoch) is the resume point
            print(f"[nan-guard] {e}; stopping — resume from the last "
                  f"epoch-end checkpoint (epoch {epoch - 1})", flush=True)
            stats.update_epoch(epoch, {"nan_aborted": True})
            return result(nan_aborted=True)
        if stop.stopping:
            # preemption: the full state and the exact batch index, so
            # --resume continues this epoch where it stopped
            ckpt.save("latest", full_state(state),
                      {"epoch": epoch - 1, "preempted": True,
                       "resume_step": tr["steps"]})
            print(f"[preempt] checkpointed at epoch {epoch} step "
                  f"{tr['steps']}/{len(train_loader)}; exiting", flush=True)
            return result(preempted=True)
        val = evaluate(state.student, val_loader, eval_step, device, n_cls)
        row = {"train_loss": tr["loss"], "train_acc": tr["acc1"],
               "ips": tr["ips"], "val_loss": val["loss"],
               "val_acc": val["acc"], "val_f1": val["f1"]}
        if ep_start:
            # resumed epoch: train stats cover only the tail batches
            row["train_partial_from"] = ep_start
        if not cfg.run.skip_test:
            test = evaluate(state.student, test_loader, eval_step, device,
                            n_cls)
            row.update(test_acc=test["acc"], test_f1=test["f1"])
        stats.update_epoch(epoch, row)
        history.append({"epoch": epoch, **row})
        print(f"epoch {epoch}: loss {tr['loss']:.4f} acc {tr['acc1']:.2f} | "
              f"val acc {val['acc']:.2f} f1 {val['f1']:.4f} | "
              f"{tr['ips']:.1f} img/s", flush=True)
        saved = full_state(state)
        meta = {"epoch": epoch, **row}
        ckpt.save("latest", saved, meta)
        if val["acc"] > best_acc:
            best_acc = val["acc"]
            ckpt.save("best_acc", saved, meta)
        if val["f1"] > best_f1:
            best_f1 = val["f1"]
            ckpt.save("best_f1", saved, meta)

    stats.write_params_json(run_dir, {
        "config": cfg.to_json(), "best_val_acc": best_acc,
        "best_val_f1": best_f1, "hours": (time.time() - t_start) / 3600.0})
    return result()
