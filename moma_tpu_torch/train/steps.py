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
once, by the first forward).  `grad_accum > 1` is not ported (ROADMAP
Queue 1 item 5) and raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.losses.functional import cross_entropy
from moma_tpu_torch.models import remat as rm
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


def make_vanilla_train_step(augment_fn: Optional[Callable] = None,
                            grad_accum: int = 1, remat: bool = False):
    """step(state, batch, generator) -> (state, {'loss', 'acc1', 'acc5'}).

    batch: {'image': NHWC on the run's device, 'label': (B,) int};
    `augment_fn(images, generator)` maps them to float images."""
    if grad_accum != 1:
        raise NotImplementedError(
            "--grad_accum > 1 is not ported to moma_tpu_torch yet (ROADMAP "
            "Queue 1 item 5)")

    def step(state: TrainState, batch, generator: torch.Generator):
        images = batch["image"]
        if augment_fn is not None:
            images = augment_fn(images, generator)
        labels = batch["label"].long()
        model = state.model
        model.train()
        _, logits = rm.checkpoint(model, images) if remat else model(images)
        loss = cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sgd_step(state.optimizer, state.schedule(state.step))
        state.step += 1
        return state, {"loss": loss.detach(), **accuracy(logits, labels)}

    return step


def make_eval_step(n_cls: int, normalize_fn: Optional[Callable] = None):
    """step(model, batch) -> (loss_sum, n_valid, conf_mat); `model` runs
    in eval mode (BN on running statistics)."""

    @torch.no_grad()
    def step(model: nn.Module, batch):
        images, labels, mask = batch["image"], batch["label"], batch["mask"]
        if normalize_fn is not None:
            images = normalize_fn(images)
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
