"""The comparison distillers: aux-module construction and the KD step.

Counterpart of moma_tpu/train/distill.py: `STATELESS` (:30),
`probe_shapes` (:34), `Distiller` (:53; `init_aux`, `init_extra` and
`loss`, its `_build` folded into `init_aux`) with its 17 methods (kd, hint,
attention, similarity, vid, nst, rkd, pkt, kdsvd, correlation, crd,
semckd, srrl, simkd, ab, fsp, ft), `make_classifier_apply` (:261),
`make_simkd_eval_step` (:275) and `make_distill_train_step` (:325).

Loss contract: total = cls*CE + div*KL(T) + beta*loss_kd.  The teacher
runs frozen in eval mode without gradients; the student and the aux
modules run in train mode, their BN running statistics updated in place
(every train-mode BatchNorm, the aux modules' too, reduces through the
channel-sum kernels); the CRD banks are updated in place after scoring.
The feature contract is the JAX package's: feats = (reductions...,
head map, pooled), NHWC maps.

In a process group of several ranks (core/mesh.py) the step is JAX's
jitted step over the global batch: each rank augments its rows from its
own stream, the student's and the aux modules' BatchNorms take sync
statistics, a MoE backbone routes the global batch
(models/vit_moe.routing_scope), and the gradients and metrics are
averaged over the ranks.
The losses that couple rows across the batch (similarity's Gram, rkd's
distances and angles, pkt's similarities, correlation's consecutive
rows, semckd's batch-similarity attention) run their one-process
function on the rows gathered from every rank in rank order
(`gather_grad`: its backward sums the ranks' gradients of the gathered
rows, which the gradient average divides back).  Every rank computes the
same global loss, so the averaged gradient is the global one.  CRD stays
per row; its Z normaliser takes the global batch's mean and every rank
writes the gathered rows into its banks, so the banks stay equal.  The
other methods are per-row means, whose average over equal shares is the
global mean.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from moma_tpu_torch.core.config import DISTILLERS, Config
from moma_tpu_torch.core.mesh import data_axis
from moma_tpu_torch.losses import aux as A
from moma_tpu_torch.losses import functional as F
from moma_tpu_torch.losses.crd import CRDMemory, crd_loss
from moma_tpu_torch.models import remat as rm
from moma_tpu_torch.models.vit_moe import routing_scope
from moma_tpu_torch.ops.fused_bn import sync_stats
from moma_tpu_torch.train.state import DistillState, sgd_step
from moma_tpu_torch.train.steps import (accuracy, average_grads, eval_sums,
                                        mean_metrics, microbatches,
                                        step_augment_generator)

STATELESS = {"kd", "attention", "similarity", "nst", "rkd", "pkt", "kdsvd",
             "ab", "fsp", "ft"}


@torch.no_grad()
def probe_shapes(model: nn.Module, image_size: int, batch_size: int = 2):
    """(feature shapes, logits shape) of an eval-mode forward, traced on
    the meta device: nothing is computed."""
    probe = copy.deepcopy(model).to("meta").eval()
    x = torch.zeros(batch_size, image_size, image_size, 3, device="meta")
    feats, logits = probe(x)
    return [tuple(f.shape) for f in feats], tuple(logits.shape)


class Distiller:
    """A method's aux modules (`init_aux`), its extra state (`init_extra`,
    the CRD memory) and its loss branch (`loss`).  The JAX class builds
    flax module definitions in `_build` and their parameters in
    `init_aux`; a torch module is both at once, so `init_aux` builds
    them."""

    def __init__(self, cfg: Config, feat_s_shapes, feat_t_shapes,
                 n_data: int = 0, batch_size: int = 0,
                 dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.method = cfg.distill.distill
        self.feat_s_shapes = [tuple(s) for s in feat_s_shapes]
        self.feat_t_shapes = [tuple(s) for s in feat_t_shapes]
        self.n_data = n_data
        self.batch_size = batch_size or cfg.data.batch_size
        self.dtype = dtype
        if self.method not in DISTILLERS:
            raise NotImplementedError(self.method)

    def init_aux(self, generator: torch.Generator) -> nn.ModuleDict:
        """The method's aux modules, in the JAX package's order, their
        weights drawn from `generator` in that order."""
        m, d, dt, g = self.method, self.cfg.distill, self.dtype, generator
        s_sh, t_sh = self.feat_s_shapes, self.feat_t_shapes
        feat_dim = self.cfg.moma.feat_dim
        mods = {}
        if m == "hint":
            mods["convreg"] = A.ConvReg(s_sh[d.hint_layer][1:],
                                        t_sh[d.hint_layer][1:], dt, g)
        elif m == "vid":
            for i, (ss, ts) in enumerate(zip(s_sh[1:-1], t_sh[1:-1])):
                mods[f"vid_{i}"] = A.VIDRegressor(ss[-1], ts[-1], ts[-1],
                                                  dtype=dt, generator=g)
        elif m == "crd":
            mods["embed_s"] = A.Embed(s_sh[-1][-1], feat_dim, g)
            mods["embed_t"] = A.Embed(t_sh[-1][-1], feat_dim, g)
        elif m == "semckd":
            mods["selfa"] = A.SelfA(
                [s[-1] for s in s_sh[1:-1]], [t[-1] for t in t_sh[1:-1]],
                self.batch_size, soft=d.soft, dtype=dt, generator=g)
        elif m == "srrl":
            mods["srrl"] = A.SRRL(s_sh[-1][-1], t_sh[-1][-1], dt, g)
        elif m == "simkd":
            mods["simkd"] = A.SimKD(s_sh[-2][-1], t_sh[-2][-1], d.factor, dt,
                                    g)
        elif m == "correlation":
            # the reference's CC embeds both sides to feat_dim
            mods["embed_s"] = A.LinearEmbed(s_sh[-1][-1], feat_dim, g)
            mods["embed_t"] = A.LinearEmbed(t_sh[-1][-1], feat_dim, g)
        return nn.ModuleDict(mods)

    def init_extra(self, generator: torch.Generator,
                   device=None) -> Optional[CRDMemory]:
        """Non-parameter state: the CRD memory banks."""
        if self.method == "crd":
            if self.n_data <= 0:
                raise ValueError("CRD needs n_data")
            return CRDMemory.create(self.n_data, self.cfg.moma.feat_dim,
                                    generator, device)
        return None

    def loss(self, aux: nn.ModuleDict, extra: Optional[CRDMemory],
             feat_s: Sequence[torch.Tensor], feat_t: Sequence[torch.Tensor],
             logit_s: torch.Tensor, logit_t: torch.Tensor, batch: dict,
             cls_t_apply: Callable, ax=None):
        """(loss_kd, logits for the metrics or None).  The logits are
        non-None for simkd only: its student is scored through the reused
        teacher classifier.  `ax`: the data axis (core/mesh.data_axis()
        by default) whose ranks' rows the batch-coupled losses gather."""
        m, d = self.method, self.cfg.distill
        ax = data_axis() if ax is None else ax
        metric_logits = None
        if m == "kd":
            loss_kd = torch.zeros((), device=logit_s.device)
        elif m == "hint":
            f_s, f_t = aux["convreg"](feat_s[d.hint_layer],
                                      feat_t[d.hint_layer])
            loss_kd = F.hint_mse(f_s, f_t)
        elif m == "attention":
            loss_kd = F.attention_transfer(feat_s[1:-1], feat_t[1:-1])
        elif m == "similarity":
            loss_kd = F.similarity_preserving([ax.gather_grad(feat_s[-2])],
                                              [ax.gather(feat_t[-2])])
        elif m == "vid":
            loss_kd = 0.0
            for i, (fs, ft) in enumerate(zip(feat_s[1:-1], feat_t[1:-1])):
                fs2, ft2 = F._match_spatial(fs, ft)
                pred_mean, log_scale = aux[f"vid_{i}"](fs2)
                loss_kd = loss_kd + F.vid_loss(pred_mean, ft2, log_scale)
        elif m == "nst":
            loss_kd = F.nst_loss(feat_s[1:-2], feat_t[1:-2])
        elif m == "rkd":
            loss_kd = F.rkd_loss(ax.gather_grad(feat_s[-1]),
                                 ax.gather(feat_t[-1]))
        elif m == "pkt":
            loss_kd = F.pkt_loss(ax.gather_grad(feat_s[-1]),
                                 ax.gather(feat_t[-1]))
        elif m == "kdsvd":
            loss_kd = F.kdsvd_loss(feat_s[1:-1], feat_t[1:-1])
        elif m == "correlation":
            loss_kd = F.cc_loss(ax.gather_grad(aux["embed_s"](feat_s[-1])),
                                ax.gather_grad(aux["embed_t"](feat_t[-1])))
        elif m == "crd":
            loss_kd = crd_loss(
                extra, aux["embed_s"](feat_s[-1]), aux["embed_t"](feat_t[-1]),
                batch["index"], batch["contrast_idx"], ax,
                nce_t=self.cfg.moma.nce_t, momentum=self.cfg.moma.nce_m)
        elif m == "semckd":
            s_value, f_target, weight = aux["selfa"](feat_s[1:-1],
                                                     feat_t[1:-1], ax)
            loss_kd = F.semckd_loss(s_value, f_target, weight)
        elif m == "srrl":
            trans_feat_s = aux["srrl"](feat_s[-1])
            loss_kd = (F.hint_mse(trans_feat_s, feat_t[-1])
                       + F.hint_mse(cls_t_apply(trans_feat_s), logit_t))
        elif m == "simkd":
            trans_s, trans_t, pooled = aux["simkd"](feat_s[-2], feat_t[-2])
            metric_logits = cls_t_apply(pooled)
            loss_kd = F.hint_mse(trans_s, trans_t)
        elif m == "ab":
            loss_kd = F.ab_loss(feat_s[1:-1], feat_t[1:-1])
        elif m == "fsp":
            loss_kd = F.fsp_loss(feat_s[:-1], feat_t[:-1])
        elif m == "ft":
            loss_kd = F.ft_loss(F.ft_factor(feat_s[-2]),
                                F.ft_factor(feat_t[-2]))
        else:
            raise NotImplementedError(m)
        return loss_kd, metric_logits


def make_classifier_apply(teacher: nn.Module) -> Callable:
    """The teacher's final classifier on a pooled embedding, in f32 (the
    cls_t reuse of simkd and srrl); gradients reach the embedding only."""
    cls = teacher.classifier

    def apply(x):
        y = x.float() @ cls.weight.float().t()
        if cls.bias is not None:
            y = y + cls.bias.float()
        return y

    return apply


def make_simkd_eval_step(distiller: Distiller, teacher: nn.Module,
                         n_cls: int, normalize_fn: Optional[Callable]):
    """Eval step for simkd: student features -> SimKD bottleneck in eval
    mode -> pooled -> the teacher's classifier.  `model` is
    nn.ModuleDict(student=..., simkd=...), which `evaluate` puts in eval
    mode; the step returns what make_eval_step's does."""
    cls_t = make_classifier_apply(teacher)
    t_shape = distiller.feat_t_shapes[-2]

    @torch.no_grad()
    def step(model: nn.ModuleDict, batch):
        images, labels, mask = batch["image"], batch["label"], batch["mask"]
        if normalize_fn is not None:
            images = normalize_fn(images)
        feat_s, _ = model["student"](images)
        dummy_t = torch.zeros((images.shape[0], *t_shape[1:]),
                              device=images.device)
        _, _, pooled = model["simkd"](feat_s[-2], dummy_t)
        return eval_sums(cls_t(pooled), labels, mask, n_cls)

    return step


def make_distill_train_step(distiller: Distiller,
                            augment_fn: Optional[Callable],
                            grad_accum: int = 1, remat: bool = False):
    """step(state: DistillState, batch, generator) -> (state, metrics).

    batch: {'image', 'label'} on the run's device, plus 'index' and
    'contrast_idx' for crd (this rank's rows in a group).  `remat`
    recomputes the student forward in the backward (models/remat.py; the
    frozen teacher's forward is gradient-free and holds nothing).
    `grad_accum = M > 1` runs the augmented batch as M equal microbatches,
    one SGD step on the averaged gradients (distill.py:329-475): BatchNorm
    (student and aux modules) sees each microbatch's statistics, the
    running statistics and the CRD banks chain from one microbatch to the
    next (each sample's bank row written once a step).  In a group,
    microbatch i on every rank is its share of the global batch's i-th
    chunk (mesh.rank_rows, the Loader's split), its statistics and coupled
    losses taken over the ranks."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    cfg = distiller.cfg
    c, dv, b = cfg.distill.cls, cfg.distill.div, cfg.distill.beta
    kd_T = cfg.distill.kd_T

    def microbatch(state: DistillState, mb: dict, ax):
        """The microbatch's backward (gradients added to .grad) and its
        metrics."""
        images, labels = mb["image"], mb["label"].long()
        with torch.no_grad():
            state.teacher.eval()
            feat_t, logit_t = state.teacher(images)
        state.student.train()
        state.aux.train()
        feat_s, logit_s = (rm.checkpoint(state.student, images) if remat
                           else state.student(images))
        loss_cls = F.cross_entropy(logit_s, labels)
        loss_div = F.kd_kl(logit_s, logit_t, kd_T)
        loss_kd, metric_logits = distiller.loss(
            state.aux, state.extra, feat_s, feat_t, logit_s, logit_t, mb,
            make_classifier_apply(state.teacher), ax)
        total = c * loss_cls + dv * loss_div + b * loss_kd
        total.backward()
        logits = metric_logits if metric_logits is not None else logit_s
        return {"loss": total.detach(), "loss_cls": loss_cls.detach(),
                "loss_div": loss_div.detach(), "loss_kd": loss_kd.detach(),
                **accuracy(logits, labels)}

    def step(state: DistillState, batch, generator: torch.Generator):
        ax = data_axis()
        batch = dict(batch)
        if augment_fn is not None:
            batch["image"] = augment_fn(
                batch["image"], step_augment_generator(generator, ax))
        state.optimizer.zero_grad(set_to_none=True)
        # the frozen eval-mode teacher normalizes by its running
        # statistics: only the student's and the aux modules' BNs sync
        with sync_stats(ax), routing_scope(ax):
            metrics = [microbatch(state, {k: v[rows]
                                          for k, v in batch.items()}, ax)
                       for rows in microbatches(batch["image"].shape[0],
                                                grad_accum)]
        average_grads(state.trainable_params(), ax, grad_accum)
        sgd_step(state.optimizer, state.schedule(state.step))
        state.step += 1
        return state, mean_metrics(metrics, ax)

    return step
