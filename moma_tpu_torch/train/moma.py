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
detects it as run_moma does, :1209-1218, when the two backbones'
parameters differ in names, and also when they differ only in shapes,
which the JAX package takes as same-arch and fails on) changes three
things.  The KL forward runs on the fixed teacher, always in eval mode
(`kl_teacher_bn` does not apply, :340-348).
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

`--remat` recomputes the student forward (and MoCoSSTT's second view) in
the backward instead of holding its activations (train/moma.py:519-523,
models/remat.py): its BN running statistics are written once, by the
first forward; every teacher and momentum-encoder forward is
gradient-free and holds nothing.

The data axis (make_moma_train_step): `--grad_accum M` runs the step as M
virtual ranks, holding one microbatch's activations at a time; under
`python -m torch.distributed.run --nproc_per_node N` the run is
data-parallel over N processes (core/mesh.py), one per GPU, with
`--bn global|local|sync` and a Shuffle-BN permutation of the global
batch.  Rank 0 writes the run directory; every rank holds the same state.

The model axis (`--model_parallel MP`, train/moma.py:270-300, :539-665,
:1276-1331): the N ranks form a (data N/MP x model MP) grid
(mesh.create_mesh) and the negative bank is split by rows over the model
ranks of a data row (the `*_sharded` steps of moma/queue.py; MoCoAtt's
queue-consuming modes through ring attention, ops/ring_attention.py).
The model ranks of a data row see the same batch and the same draws:
the Loader's rows, the augmentation streams and the Shuffle-BN slice
follow the data index.  `--grad_accum M` runs there too: each
microbatch's contrast goes through the split-bank steps (and the ring),
and the step's one enqueue writes the rows this rank owns.  In a
cross-arch run the fixed ViT KL-teacher takes the model axis as JAX's
run_moma does (:1329-1417): tensor-parallel by default
(models/vit_tp.py, with `--sequence_parallel` its residual stream split
over tokens) or pipelined (`--teacher_parallel pipeline`,
models/vit_pp.py); every model rank of a data row runs its share of the
teacher on the row's whole local batch (under --grad_accum, on each
accumulation microbatch).  A teacher of another family stays whole on
every model rank, as does the EMA copy.  Checkpoints hold the whole bank
and the whole teacher, so a run resumes at any --model_parallel and
--teacher_parallel.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Callable, List, Optional

import torch
from torch import nn

from moma_tpu_torch.core.checkpoint import CheckpointManager, StatsWriter
from moma_tpu_torch.core.config import Config, check_model_axis, check_slice
from moma_tpu_torch.core.mesh import (create_mesh, data_axis, is_main,
                                      model_axis, rank_generator, world_axis)
from moma_tpu_torch.core.schedules import lr_schedule
from moma_tpu_torch.losses import functional as F
from moma_tpu_torch.models import create_model
from moma_tpu_torch.models import remat as rm
from moma_tpu_torch.models.pretrained import load_pretrained
from moma_tpu_torch.models.vit_moe import routing_scope
from moma_tpu_torch.moma.cmo import CMOHeads
from moma_tpu_torch.moma.queue import (QueueState, contrast_ce,
                                       queue_update, random_memory,
                                       sharded_queue_update, step_moco,
                                       step_moco_att, step_moco_att_sharded,
                                       step_moco_sharded, step_moco_sstt,
                                       step_moco_sstt_sharded, step_moco_st,
                                       step_moco_st_sharded)
from moma_tpu_torch.ops import fused_effnet
from moma_tpu_torch.ops.fused_bn import FusedBatchNorm, sync_stats
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import evaluate, resume_point, run_epochs
from moma_tpu_torch.train.state import MomaState, make_sgd, sgd_step
from moma_tpu_torch.train.steps import (accuracy, average_grads,
                                        make_eval_step, mean_metrics,
                                        microbatches, step_augment_generator)
from moma_tpu_torch.train.teacher import (augment_fns, build_datasets,
                                          make_loaders)


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
    """EmaTec mode: the backbones' parameters differ in names or in
    shapes.  The JAX package compares the trees' structure only
    (train/moma.py:1209-1218), so a teacher with the student's names and
    other widths (ViT-S -> ViT-Ti, effiB2 -> effiB1) is taken as the
    momentum encoder there and fails at its first EMA update; here it
    trains in EmaTec mode."""
    return ([(n, p.shape) for n, p in student.named_parameters()]
            != [(n, p.shape) for n, p in teacher.named_parameters()])


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


def _bn_buffers(*modules) -> List[torch.Tensor]:
    """The BN running statistics (running_mean, running_var of every
    FusedBatchNorm) of the modules."""
    return [b for mod in modules if mod is not None
            for m in mod.modules() if isinstance(m, FusedBatchNorm)
            for b in (m.running_mean, m.running_var)]


@torch.no_grad()
def _snapshot(bufs: List[torch.Tensor]) -> List[torch.Tensor]:
    # one multi-tensor copy: a clone per buffer would cost a launch each
    return torch._foreach_mul(bufs, 1.0) if bufs else []


@torch.no_grad()
def _restore(bufs: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    if bufs:
        torch._foreach_copy_(bufs, saved)


@torch.no_grad()
def _mean_of(snaps: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Per buffer, the mean over two or more snapshots
    (train/moma.py:1044-1050), in multi-tensor operations."""
    total = torch._foreach_add(snaps[0], snaps[1])
    for snap in snaps[2:]:
        torch._foreach_add_(total, snap)
    torch._foreach_div_(total, float(len(snaps)))
    return total


def make_moma_train_step(cfg: Config, augment_fn: Optional[Callable],
                         kl_train_bn_override: Optional[bool] = None,
                         cross_arch: bool = False):
    """step(state, batch, generator) -> (state, metrics).

    batch: {'image': NHWC on the run's device, 'label': (B,) int, optional
    'shuffle_perm': (B_global,) int}, this rank's rows in a process group.
    `generator` (CPU) is the step's, the same on every rank: it draws the
    Shuffle-BN permutation, and one process's augmentation (a rank's and a
    microbatch's come from mesh.rank_generator).  `cross_arch`: the EmaTec
    step, for a state with its EMA copy (`state.ema`, build_state).

    `--bn` (cfg.run.bn) in a group of several ranks (core/mesh.py):
    'local' gives each rank's BatchNorms its own statistics and makes the
    Shuffle-BN permutation cross ranks (train/moma.py:393-415, :466-482):
    the ranks' augmented images are gathered, one permutation of the
    global batch is shared, each rank runs the key forward on its slice of
    the permuted batch, then the keys are gathered and unshuffled;
    atts_q / atts_k mix a rank's own rows, the keys entering the queue are
    the gathered ones and the pointer advances by the global batch;
    gradients, BN running statistics (student and momentum encoder) and
    metrics are averaged over the ranks (:656-692).  'sync' is 'local'
    with sync-BN statistics (fused_bn.sync_stats, :1129-1135).  'global' is
    JAX's global-batch step: sync-BN statistics, and the batch-token
    attention over the global rows, whose inputs are gathered with their
    gradient; each rank keeps its rows of the logits; a MoE backbone
    routes the global batch, rank by rank (models/vit_moe.routing_scope),
    where 'local' and 'sync' route each rank's rows alone.  In one process
    the three are the same step.

    `cfg.run.grad_accum = M > 1` is JAX's accumulated step
    (train/moma.py:721-1107): microbatch i is virtual rank i of the 'local'
    step.  Phase A runs the M teacher KL forwards, each from the pre-step
    running statistics; phase B the post-EMA momentum-encoder key forwards
    over the Shuffle-BN-permuted global batch, microbatch i being rows
    perm[i*mb:(i+1)*mb], keeping only the (B, D) keys; phase C the
    student's forward and backward a microbatch at a time against the full
    keys and the pre-update queue.  Then one SGD step on the averaged
    gradients, one queue advance by B, and the BN running statistics
    averaged over the microbatches.  On W data ranks (`--bn global` only,
    as in JAX) each rank holds its B/(M*W) rows of every microbatch
    (mesh.rank_rows): microbatch i spans every rank, its BN statistics
    synced over them and its batch-token attention over its gathered
    rows, and a MoE backbone routes its rows together (rank by rank within
    the microbatch, the order of _microbatch_major), so the step is the
    one-process step (JAX's runs its microbatches
    over the whole mesh: M virtual ranks, whatever W is).

    `cfg.run.model_parallel = MP > 1` splits the bank over the model ranks
    (mesh.create_mesh must have made the grid): the `*_sharded` steps of
    moma/queue.py, MoCoAtt's queue-consuming modes through ring attention
    (CMOHeads.ring_attn_fns).  The gradients are averaged over every rank
    of the grid: over the data ranks as without it, and over the model
    ranks, which JAX does for the ring modes only (:657-665).  The other
    modes' model ranks compute alike, but a card's nondeterministic
    backward kernels (cuDNN's weight gradients) would let their replicas
    drift; the mean of MP equal values changes nothing for MP a power of
    2."""
    check_slice(cfg)
    c, dv, b = cfg.distill.cls, cfg.distill.div, cfg.distill.beta
    remat = cfg.run.remat
    kd_T = cfg.distill.kd_T
    alpha = cfg.moma.alpha
    nce_t = cfg.moma.nce_t
    mem = cfg.moma.mem
    # self_viz trains exactly as 'self' (same module set; cmo.py ATTN_SETS)
    attn = "self" if cfg.moma.attn == "self_viz" else cfg.moma.attn
    # embed_t is EMA-tracked for the mlp heads only (train/moma.py:382-389)
    ema_head = cfg.moma.head in ("mlp", "mlp_byol")
    shuffle_bn = cfg.moma.shuffle_bn
    bn_mode = cfg.run.bn
    M = int(cfg.run.grad_accum)
    use_fused = cfg.moma.fused_teacher == "on" and not cross_arch
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
    # the JAX package's refusals (train/moma.py:243-274), its messages
    if M > 1:
        if bn_mode != "global":
            raise ValueError(
                "--grad_accum with --bn local/sync would nest two rank "
                "semantics (microbatches ARE the virtual DDP ranks); use "
                "bn='global' with grad_accum, or bn='local' alone")
        if use_fused:
            raise ValueError("--grad_accum does not compose with "
                             "fused_teacher (single-chip jit optimization)")
        if fast_teacher:
            raise ValueError("--grad_accum does not compose with "
                             "fast_teacher (per-rank KL/key forwards are "
                             "distinct passes in the accumulated step)")
    if bn_mode not in ("global", "local", "sync"):
        raise ValueError(f"unknown bn mode {bn_mode!r}")
    if bn_mode != "global" and use_fused:
        raise ValueError("fused_teacher is a single-chip jit-path "
                         "optimization; use bn='global'")
    need_kt = cross_arch and mem in ("MoCoST", "MoCoSSTT")
    mp = int(cfg.run.model_parallel)
    check_model_axis(cfg, cross_arch)
    sharded = mp > 1

    def contrast(queue: QueueState, fns, q, qt, k, kt, all_k, gather,
                 ring_fns=None):
        """(the logit sets of the loss, the queue after the enqueue) of the
        memory variant: q / qt the queries (qt: MoCoSSTT's second view),
        k / kt the positive keys of q's rows (kt: cross-arch memory_t's),
        all_k the global keys (MoCo's and MoCoAtt's enqueue); `gather`
        maps MoCoST / MoCoSSTT's per-rank keys to those entering the
        queue.  With the bank split over the model axis the `*_sharded`
        steps run, MoCoAtt's through `ring_fns`."""
        self_attn = attn == "self" and bool(fns)
        mx = model_axis()
        if mem == "MoCoAtt":
            if sharded:
                logits, new_queue = step_moco_att_sharded(
                    queue, q, k, all_k, nce_t, attn, fns, mx,
                    ring_fns=ring_fns)
            else:
                logits, new_queue = step_moco_att(queue, q, k, all_k, nce_t,
                                                  attn, fns)
            return [logits], new_queue
        if mem in ("MoCoST", "MoCoSSTT"):
            # same-arch: the momentum encoder's keys fill both banks;
            # cross-arch: the fixed teacher's fill memory_t.  The
            # teacher-side keys stay the raw ones (train/moma.py:560-561);
            # atts_k mixes only q's own rows
            q_in, k_in = q, k
            kt_in = kt if kt is not None else k
            if self_attn:
                q_in = fns["atts_q"](q_in)
                with torch.no_grad():
                    k_in = fns["atts_k"](k_in)
            extra = (mx,) if sharded else ()
            if mem == "MoCoSSTT":
                qt_in = fns["atts_q"](qt) if self_attn else qt
                *logits_list, new_queue = (
                    step_moco_sstt_sharded if sharded else step_moco_sstt)(
                    queue, q_in, k_in, qt_in, kt_in, gather(k_in),
                    gather(kt_in), nce_t, *extra)
                return logits_list, new_queue
            logits_ss, _, new_queue = (
                step_moco_st_sharded if sharded else step_moco_st)(
                queue, q_in, k_in, kt_in, gather(k_in), gather(kt_in), nce_t,
                *extra)
            # the loss takes the first logit set only
            return [logits_ss], new_queue
        # MoCo: atts_queue transforms the keys ENTERING the queue, not the
        # queue memory
        q_in, k_in, keys_in = q, k, all_k
        if self_attn:
            q_in = fns["atts_q"](q_in)
            with torch.no_grad():
                k_in = fns["atts_k"](k)
                keys_in = fns["atts_queue"](all_k)
        if sharded:
            logits, new_queue = step_moco_sharded(queue, q_in, k_in, keys_in,
                                                  nce_t, mx)
        else:
            logits, new_queue = step_moco(queue, q_in, k_in, keys_in, nce_t)
        return [logits], new_queue

    def student_losses(state, images, labels, logit_t):
        """Student forward: (feat_s, logit_s, loss_cls, loss_div, q)."""
        student, heads = state.student, state.heads
        student.train()
        heads.embed_s.train()
        feat_s, logit_s = (rm.checkpoint(student, images) if remat
                           else student(images))
        loss_cls = F.cross_entropy(logit_s, labels)
        loss_div = F.kd_kl(logit_s, logit_t, kd_T)
        return logit_s, loss_cls, loss_div, heads.embed_s(feat_s[-1])

    def second_view(state, images2):
        """MoCoSSTT's query on the second view; the view's BN running
        statistics are discarded (train/moma.py:573)."""
        with _buffers_restored(state.student, state.heads.embed_s):
            feat_s2, _ = (rm.checkpoint(state.student, images2) if remat
                          else state.student(images2))
            return state.heads.embed_s(feat_s2[-1])

    def ema_step(state, momentum, key_head):
        ema_update(momentum, state.student, alpha)
        if ema_head:
            ema_update(key_head, state.heads.embed_s, alpha)

    def finish(state, ax, metrics, new_queue):
        """Average the gradients and the metrics (microbatches, then the
        ranks: every rank of the grid, whose model ranks' ring orders
        differ in float rounding), one SGD step, the queue advance."""
        ax = world_axis() if sharded else ax
        average_grads(state.trainable_params(), ax, len(metrics))
        sgd_step(state.optimizer, state.schedule(state.step))
        state.queue = new_queue
        state.step += 1
        return state, {**mean_metrics(metrics, ax), "queue_ptr": new_queue.ptr}

    def step_metrics(total, loss_cls, loss_div, loss_kd, logit_s, labels):
        return {"loss": total.detach(), "loss_cls": loss_cls.detach(),
                "loss_div": loss_div.detach(), "loss_kd": loss_kd.detach(),
                **accuracy(logit_s, labels)}

    def step(state: MomaState, batch, generator: torch.Generator):
        if cross_arch != (state.ema is not None):
            raise ValueError(
                f"a {'cross' if cross_arch else 'same'}-arch step for a "
                f"state {'without' if cross_arch else 'with'} an EMA copy")
        if model_axis().size != mp:
            raise ValueError(
                f"--model_parallel {mp} needs the (data, model) grid of "
                f"mesh.create_mesh({mp}); the grid's model axis has "
                f"{model_axis().size} rank(s)")
        ax = data_axis()
        if M > 1:
            with sync_stats(ax), routing_scope(ax):
                return accum_step(state, batch, generator, ax)
        if ax.world > 1 and use_fused:
            raise ValueError(
                "--fused_teacher on runs the teacher forwards on one "
                "process (its kernels take per-process BN statistics); "
                "drop it for world_size > 1")
        with sync_stats(ax if bn_mode in ("sync", "global") else None), \
                routing_scope(ax if bn_mode == "global" else None):
            return rank_step(state, batch, generator, ax)

    def rank_step(state, batch, generator, ax):
        student, teacher, heads = state.student, state.teacher, state.heads
        # the momentum encoder and its key head
        momentum = state.ema if cross_arch else teacher
        key_head = heads.embed_ema if cross_arch else heads.embed_t
        g_aug = step_augment_generator(generator, ax)
        images = batch["image"]
        if augment_fn is not None:
            images = augment_fn(images, g_aug)
        labels = batch["label"].long()
        B = images.shape[0]

        # 1. KL forward, pre-EMA teacher (none with fast_teacher: step 3's
        # logits stand in); cross-arch: the fixed teacher in eval mode
        if not fast_teacher:
            with torch.no_grad():
                pooled_t, logit_t = teacher_forward(
                    teacher, images, kl_train_bn and not cross_arch)

        # 2. EMA from the pre-step student
        ema_step(state, momentum, key_head)

        # 3. keys through the post-EMA momentum encoder, BN in train mode,
        # on this rank's slice of the permuted global batch
        with torch.no_grad():
            if shuffle_bn:
                all_images = ax.gather(images)
                if "shuffle_perm" in batch:
                    perm = batch["shuffle_perm"].to(images.device).long()
                else:
                    perm = torch.randperm(all_images.shape[0],
                                          generator=generator).to(
                                              images.device)
                inv = torch.argsort(perm)
                key_images = all_images[ax.local_slice(perm, B)]
            else:
                key_images = images
            pooled_key, logit_key = teacher_forward(momentum, key_images,
                                                    True)
            key_head.eval()  # the momentum head runs in eval mode
            k_emb = key_head(pooled_key)
            if shuffle_bn:
                all_k = ax.gather(k_emb)[inv]
                k_emb = ax.local_slice(all_k, B)
            else:
                all_k = ax.gather(k_emb)
            if fast_teacher:
                # post-EMA teacher, train-mode BN: a documented deviation
                logit_t = (ax.local_slice(ax.gather(logit_key)[inv], B)
                           if shuffle_bn else logit_key)
            kt_emb = all_kt = None
            if need_kt:
                # the fixed teacher's keys for memory_t
                heads.embed_t.eval()
                kt_emb = heads.embed_t(pooled_t)
                all_kt = ax.gather(kt_emb)
        # MoCoSSTT's second view, drawn after the permutation as in JAX
        images2 = None
        if mem == "MoCoSSTT":
            images2 = (augment_fn(batch["image"], g_aug)
                       if augment_fn is not None else images)

        # 4-6. student, contrast against the pre-update queue, SGD
        logit_s, loss_cls, loss_div, q = student_losses(state, images,
                                                        labels, logit_t)
        qt = second_view(state, images2) if images2 is not None else None
        fns = heads.attn_fns()
        ring = heads.ring_attn_fns(model_axis()) if sharded else None
        if bn_mode == "global" and ax.world > 1:
            # the global batch's contrast, as one process would run it,
            # with the queries gathered with their gradient; each rank
            # keeps its rows of the logits
            logits_list, new_queue = contrast(
                state.queue, fns, ax.gather_grad(q),
                ax.gather_grad(qt) if qt is not None else None, all_k,
                all_kt, all_k, lambda x: x, ring)
            logits_list = [ax.local_slice(lg, B) for lg in logits_list]
        else:
            logits_list, new_queue = contrast(state.queue, fns, q, qt,
                                              k_emb, kt_emb, all_k, ax.gather,
                                              ring)
        loss_kd = sum(contrast_ce(lg) for lg in logits_list) / len(
            logits_list)
        total = c * loss_cls + dv * loss_div + b * loss_kd

        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if bn_mode == "local":
            # per-rank running statistics -> their mean (the EMA write is
            # linear and every rank starts from the same statistics)
            ax.pmean_(_bn_buffers(student, heads.embed_s, momentum))
        return finish(state, ax, [step_metrics(
            total, loss_cls, loss_div, loss_kd, logit_s, labels)], new_queue)

    def accum_step(state, batch, generator, ax):
        student, teacher, heads = state.student, state.teacher, state.heads
        momentum = state.ema if cross_arch else teacher
        key_head = heads.embed_ema if cross_arch else heads.embed_t
        raw = batch["image"]
        labels = batch["label"].long()
        W = ax.world
        # this rank's rows: its B/(M*W) of each microbatch (mesh.rank_rows)
        rows = microbatches(raw.shape[0], M)
        lb = raw.shape[0] // M
        mb = lb * W
        B = mb * M
        # rank r's share of microbatch i: global rows i*mb + r*lb + [0, lb)
        own = [slice(i * mb + ax.rank * lb, i * mb + (ax.rank + 1) * lb)
               for i in range(M)]
        gens = [rank_generator(generator, i * W + ax.rank) for i in range(M)]
        m_bufs = _bn_buffers(momentum)
        pre = _snapshot(m_bufs)
        kl_writes = kl_train_bn and not cross_arch

        # phase A: augment + teacher KL forward per virtual rank, each from
        # the pre-step running statistics
        images, logit_t, pooled_t, after_kl = [], [], [], []
        with torch.no_grad():
            for i, r in enumerate(rows):
                im = (augment_fn(raw[r], gens[i]) if augment_fn is not None
                      else raw[r])
                if kl_writes:
                    _restore(m_bufs, pre)
                p_t, l_t = teacher_forward(teacher, im, kl_writes)
                if kl_writes:
                    after_kl.append(_snapshot(m_bufs))
                images.append(im)
                logit_t.append(l_t)
                pooled_t.append(p_t)

        ema_step(state, momentum, key_head)

        # phase B: the momentum encoder's key forwards over the permuted
        # global batch, rank i's statistics continuing from its KL forward
        # (cross-arch: the EMA copy's pre-step ones); only the keys stay
        with torch.no_grad():
            all_images = _microbatch_major(ax.gather(torch.cat(images)), W,
                                           M)
            if shuffle_bn:
                if "shuffle_perm" in batch:
                    perm = batch["shuffle_perm"].to(raw.device).long()
                else:
                    perm = torch.randperm(B, generator=generator).to(
                        raw.device)
                inv = torch.argsort(perm)
            keys, after_key = [], []
            for i in range(M):
                _restore(m_bufs, after_kl[i] if after_kl else pre)
                key_images = (all_images[perm[own[i]]] if shuffle_bn
                              else images[i])
                pooled_key, _ = teacher_forward(momentum, key_images, True)
                key_head.eval()  # the momentum head runs in eval mode
                keys.append(key_head(pooled_key))
                after_key.append(_snapshot(m_bufs))
            del all_images
            _restore(m_bufs, _mean_of(after_key))
            all_k = _microbatch_major(ax.gather(torch.cat(keys)), W, M)
            if shuffle_bn:
                all_k = all_k[inv]
            all_kt = None
            if need_kt:
                heads.embed_t.eval()
                all_kt = _microbatch_major(
                    ax.gather(heads.embed_t(torch.cat(pooled_t))), W, M)

        # phase C: the student's gradients per virtual rank against the
        # full keys and the pre-update queue
        s_bufs = _bn_buffers(student, heads.embed_s)
        s_pre = _snapshot(s_bufs)
        fns = heads.attn_fns()
        mx = model_axis()
        ring = heads.ring_attn_fns(mx) if sharded else None
        state.optimizer.zero_grad(set_to_none=True)
        metrics, after_s = [], []
        for i, r in enumerate(rows):
            _restore(s_bufs, s_pre)
            logit_s, loss_cls, loss_div, q = student_losses(
                state, images[i], labels[r], logit_t[i])
            qt = None
            if mem == "MoCoSSTT":
                im2 = (augment_fn(raw[r], gens[i]) if augment_fn is not None
                       else images[i])
                qt = second_view(state, im2)
            # microbatch i's contrast over its rows on every rank, the
            # queries gathered with their gradient; this rank keeps its own
            g = slice(i * mb, (i + 1) * mb)
            logits_list, new_queue = contrast(
                state.queue, fns, ax.gather_grad(q),
                ax.gather_grad(qt) if qt is not None else None, all_k[g],
                all_kt[g] if all_kt is not None else None, all_k,
                lambda x: x, ring)
            logits_list = [ax.local_slice(lg, lb) for lg in logits_list]
            loss_kd = sum(contrast_ce(lg) for lg in logits_list) / len(
                logits_list)
            total = c * loss_cls + dv * loss_div + b * loss_kd
            total.backward()
            after_s.append(_snapshot(s_bufs))
            metrics.append(step_metrics(total, loss_cls, loss_div, loss_kd,
                                        logit_s, labels[r]))
        _restore(s_bufs, _mean_of(after_s))

        # one queue advance by the global key count, with the pre-step
        # attention parameters (train/moma.py:1052-1080): MoCo's and
        # MoCoAtt's is the last contrast call's, which enqueued the global
        # keys; MoCoST / MoCoSSTT's atts_k mixes only a virtual rank's rows.
        # A split bank takes the rows this rank owns
        if mem in ("MoCoST", "MoCoSSTT"):
            with torch.no_grad():
                k_in = (torch.cat([fns["atts_k"](all_k[i * mb:(i + 1) * mb])
                                   for i in range(M)])
                        if attn == "self" and fns else all_k)
                keys = {"memory_s": k_in,
                        "memory_t": all_kt if all_kt is not None else all_k}
                new_queue = (sharded_queue_update(state.queue, keys, mx)
                             if sharded else queue_update(state.queue, keys))
        return finish(state, ax, metrics, new_queue)

    return step


def _microbatch_major(t: torch.Tensor, world: int, M: int) -> torch.Tensor:
    """Rows gathered rank by rank, each rank's M microbatch shares in
    turn, put back in the global batch's order (microbatch by
    microbatch, rank by rank within it)."""
    if world == 1:
        return t
    return t.reshape(world, M, -1, *t.shape[1:]).transpose(0, 1).reshape(
        t.shape)


def build_state(cfg: Config, device: torch.device, steps_per_epoch: int,
                seed: int) -> MomaState:
    """Student, teacher, CMO heads, queue and SGD from seeded generators;
    the student and teacher then take --std_pre / --tec_pre weights where
    given (load_pretrained; an unresolvable tag raises).  Backbones whose
    parameters differ in names or shapes make a cross-arch (EmaTec) state:
    its momentum encoder `ema` is a distinct copy of the student, its heads
    gain embed_ema."""
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
    check_model_axis(cfg, cross_arch, teacher, data_axis().world)
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
    if cross_arch:
        teacher = parallel_teacher(cfg, teacher)
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
    # the whole seed-made bank, of which each model rank keeps its rows:
    # the same bank at any --model_parallel
    mx = model_axis()
    queue = QueueState({name: mx.shard_rows(random_memory(
        cfg.moma.nce_k, feat_dim, g_queue, device)) for name in banks})
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


def parallel_teacher(cfg: Config, teacher: nn.Module) -> nn.Module:
    """The cross-arch KL-teacher on the model axis (train/moma.py:1329-
    1417): at --model_parallel MP > 1 a MoE ViT teacher becomes this
    rank's E/MP experts (--teacher_parallel expert,
    models/vit_moe.EPMoEVisionTransformer), a ViT teacher this rank's share
    of the pipeline (--teacher_parallel pipeline,
    models/vit_pp.PPVisionTransformer) or of the tensor-parallel teacher
    (models/vit_tp.TPVisionTransformer, with --sequence_parallel its
    residual stream split over tokens); any other teacher (a MoE ViT
    under the default --teacher_parallel tensor too) stays whole on every
    model rank.  check_model_axis has checked the route."""
    from moma_tpu_torch.models.vit_moe import EPMoEVisionTransformer
    from moma_tpu_torch.models.vit_pp import PPVisionTransformer
    from moma_tpu_torch.models.vit_tp import TPVisionTransformer, is_tp_model

    r = cfg.run
    mp = r.model_parallel
    if mp <= 1:
        return teacher
    if r.teacher_parallel == "expert":
        placed = EPMoEVisionTransformer(teacher, model_axis())
        note = (f"[moma] MoE ViT teacher expert-parallel over "
                f"'model'={mp}: {teacher.num_experts} experts -> "
                f"{teacher.num_experts // mp}/chip")
    elif not is_tp_model(teacher):
        return teacher
    elif r.teacher_parallel == "pipeline":
        n_micro = r.pp_microbatch or mp
        placed = PPVisionTransformer(teacher, model_axis(), n_micro,
                                     data_axis().world)
        note = (f"[moma] ViT teacher pipeline-parallel over 'model'={mp}: "
                f"{len(teacher.blocks) // mp} blocks/stage, {n_micro} "
                "microbatches")
    else:
        placed = TPVisionTransformer(teacher, model_axis(),
                                     r.sequence_parallel)
        sp_note = (" + sequence-parallel residual stream"
                   if r.sequence_parallel else "")
        note = (f"[moma] ViT teacher tensor-parallel over 'model'={mp}: "
                f"attention heads {teacher.num_heads}->"
                f"{teacher.num_heads // mp}/chip, MLP hidden sharded"
                f"{sp_note}")
    if is_main():
        print(note, flush=True)
    if data_axis().rank == 0:
        own, whole = placed.block_bytes()
        print(f"[moma] model rank {model_axis().index} holds {own} of the "
              f"teacher's {whole} bytes of block weights", flush=True)
    return placed


def teacher_state_dict(teacher: nn.Module) -> dict:
    """The teacher's whole state dict: a tensor-, pipeline- or
    expert-parallel teacher's gathered from the model ranks (every model
    rank calls it)."""
    return getattr(teacher, "dense_state_dict", teacher.state_dict)()


def full_state(state: MomaState) -> dict:
    """The checkpointable state: both backbones with their BN buffers (a
    tensor-, pipeline- or expert-parallel teacher gathered whole, so a run
    resumes at any --model_parallel and --teacher_parallel), in cross-arch
    runs the EMA copy with its own (train/moma.py:1468-1481), the heads, every
    queue bank whole (a split bank gathered over the model ranks, as JAX's
    file holds the global array) and its pointer, the optimizer's buffers
    and the step.  Every rank calls it."""
    mx = model_axis()
    out = {"student": state.student.state_dict(),
           "teacher": teacher_state_dict(state.teacher),
           "heads": state.heads.state_dict(),
           "queue": {"memory": {k: mx.all_gather(v, 0)
                                for k, v in state.queue.memory.items()},
                     "ptr": state.queue.ptr},
           "optimizer": state.optimizer.state_dict(),
           "step": state.step}
    if state.ema is not None:
        out["ema"] = state.ema.state_dict()
    return out


def load_full_state(state: MomaState, saved: dict) -> MomaState:
    """Copy a `full_state` dict into `state` in place (the modules keep
    their storage, so views taken of them stay valid); each model rank
    takes its rows of the whole bank.  A cross-arch checkpoint without the
    EMA copy restores the rest and warns: the momentum encoder keeps the
    copy made at start (train/moma.py:1485-1500)."""
    if state.ema is not None:
        if "ema" in saved:
            state.ema.load_state_dict(saved["ema"])
        else:
            print("[resume] WARNING: old cross-arch checkpoint without the "
                  "EMA copy — the EmaTec momentum encoder restarts from "
                  "the copy of the student made at start", flush=True)
    state.student.load_state_dict(saved["student"])
    getattr(state.teacher, "load_dense_state_dict",
            state.teacher.load_state_dict)(saved["teacher"])
    state.heads.load_state_dict(saved["heads"])
    mem = saved["queue"]["memory"]
    if set(mem) != set(state.queue.memory):
        raise ValueError(f"checkpoint queue banks {sorted(mem)} differ from "
                         f"the run's {sorted(state.queue.memory)}")
    mx = model_axis()
    state.queue = QueueState({k: mx.shard_rows(v) for k, v in mem.items()},
                             int(saved["queue"]["ptr"]))
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
    # the (data, model) grid; the Loaders shard by the data index
    create_mesh(cfg.run.model_parallel)
    run_dir = os.path.join(cfg.run.save_dir, f"moma_{cfg.run_name}")
    os.makedirs(run_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"),
                             map_location=device)
    n_cls = cfg.model_s.n_cls
    _, train_loader, val_loader, test_loader = make_loaders(
        cfg, synthetic, device, datasets=build_datasets(cfg, synthetic))
    state = build_state(cfg, device, len(train_loader), cfg.run.seed)

    train_aug, eval_norm = augment_fns(cfg)
    cross_arch = state.ema is not None
    if cfg.run.model_parallel > 1 and world_axis().rank == 0:
        print(f"[moma] negative queue (K={cfg.moma.nce_k}) split over the "
              f"model axis: {cfg.moma.nce_k // cfg.run.model_parallel} rows "
              f"on each of {cfg.run.model_parallel} model ranks", flush=True)
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

    saved, *start = resume_point(cfg, ckpt)
    if saved is not None:
        load_full_state(state, saved)
    first_fn, rest_fn = (step_fn if isinstance(step_fn, tuple)
                         else (step_fn, step_fn))

    def epoch_step(ep_start):
        # 'exact': eval-BN KL forward on the epoch's first batch (the
        # per-epoch model_t.eval() reset), train-BN after.  A mid-epoch
        # resume already ran the epoch's first batch before the
        # preemption, so it takes the train-BN step throughout.
        seen = [0 if ep_start == 0 else 1]

        def step(s, b, g):
            fn = first_fn if seen[0] == 0 else rest_fn
            seen[0] += 1
            return fn(s, b, g)
        return step

    loaders = {"val": val_loader, "test": test_loader}
    return run_epochs(
        cfg, state, epoch_step=epoch_step,
        evaluate_fn=lambda st, split: evaluate(st.student, loaders[split],
                                               eval_step, device, n_cls),
        full_state=full_state, train_loader=train_loader, device=device,
        ckpt=ckpt, stats=StatsWriter(run_dir), run_dir=run_dir, start=start,
        stop=stop)
