"""Vanilla supervised train step and the evaluation step.

Counterpart of moma_tpu/train/steps.py: `make_vanilla_train_step` (:28)
and `make_eval_step` (:126-148).  The train step augments on the device,
runs the train-mode forward (BN running statistics updated in place, every
train-mode BatchNorm through the channel-sum kernels), takes the mean
cross-entropy, its backward and one SGD step; its metrics stay on the
device.  The eval step returns the summed NLL over the valid rows of a
(possibly padded) batch, the valid count and the confusion matrix, also
on the device, so an epoch fetches once.

`remat` recomputes the train-mode forward in the backward instead of
holding its activations (models/remat.py; BN running statistics written
once, by the first forward).  `grad_accum = M > 1` splits the (augmented)
batch into M equal microbatches, each a forward and a backward, with one
SGD step on the gradients averaged over them (steps.py:83-123): each
microbatch is a virtual DDP rank whose BatchNorms see its own statistics,
and the running statistics chain from one microbatch to the next (the
in-place running update does that by itself), as in JAX.

In a process group of several ranks (core/mesh.py) each rank runs its
rows of the global batch with sync-BN statistics, a MoE backbone routing
the global batch (models/vit_moe.routing_scope; the eval step too), and
the gradients and metrics are averaged over the ranks: JAX's global-batch
step on N devices (`--bn global`).  Each rank draws its augmentation from
its own stream (mesh.rank_generator).  Under `grad_accum` the Loader hands each rank its
share of every microbatch (mesh.rank_rows), so microbatch i, its
statistics synced over the ranks, is the global batch's i-th contiguous
chunk, as in JAX and in one process.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.core.mesh import data_axis, rank_generator
from moma_tpu_torch.losses.functional import cross_entropy
from moma_tpu_torch.models import remat as rm
from moma_tpu_torch.models.vit_moe import routing_scope
from moma_tpu_torch.ops.fused_bn import sync_stats
from moma_tpu_torch.train.state import TrainState, sgd_step


def confusion_matrix_t(logits: torch.Tensor, labels: torch.Tensor,
                       n_cls: int, mask: Optional[torch.Tensor] = None):
    """(n_cls, n_cls) float32 conf-mat [true, pred] on the logits' device."""
    pred = logits.argmax(-1)
    w = (torch.ones_like(labels, dtype=torch.float32) if mask is None
         else mask.float())
    cm = torch.zeros(n_cls, n_cls, dtype=torch.float32, device=logits.device)
    return cm.index_put_((labels.long(), pred), w, accumulate=True)


@torch.no_grad()
def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """{'acc1', 'acc5'} in percent, on the device."""
    k5 = min(5, logits.shape[-1])
    return {"acc1": (logits.argmax(-1) == labels).float().mean() * 100.0,
            "acc5": (logits.topk(k5, -1).indices == labels[:, None])
            .any(-1).float().mean() * 100.0}


def microbatches(n_rows: int, grad_accum: int):
    """The row slices of `grad_accum` equal microbatches of a batch; raises
    when the batch does not split evenly (the JAX package's message)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if n_rows % grad_accum != 0:
        raise ValueError(f"batch size {n_rows} not divisible by "
                         f"grad_accum={grad_accum}")
    mb = n_rows // grad_accum
    return [slice(i * mb, (i + 1) * mb) for i in range(grad_accum)]


def step_augment_generator(generator: torch.Generator, ax):
    """The generator a rank augments its rows with: the step's own in one
    process, its rank's stream in a group (mesh.rank_generator)."""
    return generator if ax.world == 1 else rank_generator(generator,
                                                          ax.rank)


def average_grads(params, ax, grad_accum: int = 1) -> None:
    """Gradients summed over `grad_accum` microbatches -> their mean, then
    averaged over the ranks (one bucketed all_reduce)."""
    if grad_accum == 1 and ax.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grad_accum > 1 and grads:
        torch._foreach_div_(grads, float(grad_accum))
    ax.pmean_(grads)


def mean_metrics(metrics: List[Dict[str, torch.Tensor]], ax) -> dict:
    """A step's metrics: the microbatches' dicts of scalars averaged over
    them, then over the ranks (one all_reduce); one microbatch in one
    process is returned as it is."""
    if len(metrics) == 1 and ax.world == 1:
        return metrics[0]
    names = list(metrics[0])
    mean = torch.stack([torch.stack([m[k].float() for k in names])
                        for m in metrics]).mean(0)
    ax.pmean_([mean])
    return dict(zip(names, mean.unbind()))


def make_vanilla_train_step(augment_fn: Optional[Callable] = None,
                            grad_accum: int = 1, remat: bool = False):
    """step(state, batch, generator) -> (state, {'loss', 'acc1', 'acc5'}).

    batch: {'image': NHWC on the run's device, 'label': (B,) int};
    `augment_fn(images, generator)` maps them to float images."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch, generator: torch.Generator):
        ax = data_axis()
        images = batch["image"]
        if augment_fn is not None:
            images = augment_fn(images, step_augment_generator(generator,
                                                               ax))
        labels = batch["label"].long()
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        metrics = []
        with sync_stats(ax), routing_scope(ax):
            for rows in microbatches(images.shape[0], grad_accum):
                _, logits = (rm.checkpoint(model, images[rows]) if remat
                             else model(images[rows]))
                loss = cross_entropy(logits, labels[rows])
                loss.backward()
                metrics.append({"loss": loss.detach(),
                                **accuracy(logits, labels[rows])})
        average_grads(model.parameters(), ax, grad_accum)
        sgd_step(state.optimizer, state.schedule(state.step))
        state.step += 1
        return state, mean_metrics(metrics, ax)

    return step


def make_eval_step(n_cls: int, normalize_fn: Optional[Callable] = None):
    """step(model, batch) -> (loss_sum, n_valid, conf_mat); `model` runs
    in eval mode (BN on running statistics)."""

    @torch.no_grad()
    def step(model: nn.Module, batch):
        images, labels, mask = batch["image"], batch["label"], batch["mask"]
        if normalize_fn is not None:
            images = normalize_fn(images)
        with routing_scope(data_axis()):
            _, logits = model(images)
        return eval_sums(logits, labels, mask, n_cls)

    return step


def eval_sums(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
              n_cls: int):
    """(summed NLL over the valid rows, valid count, confusion matrix)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum(), m.sum(), confusion_matrix_t(logits, labels,
                                                        n_cls, mask)
