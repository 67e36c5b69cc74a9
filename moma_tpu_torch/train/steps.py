"""Evaluation step.

Counterpart of moma_tpu/train/steps.py::make_eval_step (:126-148): the
summed NLL over the valid rows of a (possibly padded) batch, the valid
count and the confusion matrix, all left on the device so an epoch fetches
once.  The vanilla supervised step is not ported yet (ROADMAP Queue 1
item 3).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def confusion_matrix_t(logits: torch.Tensor, labels: torch.Tensor,
                       n_cls: int, mask: Optional[torch.Tensor] = None):
    """(n_cls, n_cls) float32 conf-mat [true, pred] on the logits' device."""
    pred = logits.argmax(-1)
    w = (torch.ones_like(labels, dtype=torch.float32) if mask is None
         else mask.float())
    cm = torch.zeros(n_cls, n_cls, dtype=torch.float32, device=logits.device)
    return cm.index_put_((labels.long(), pred), w, accumulate=True)


def make_eval_step(n_cls: int, normalize_fn: Optional[Callable] = None):
    """step(model, batch) -> (loss_sum, n_valid, conf_mat); `model` runs
    in eval mode (BN on running statistics)."""

    @torch.no_grad()
    def step(model: nn.Module, batch):
        images, labels, mask = batch["image"], batch["label"], batch["mask"]
        if normalize_fn is not None:
            images = normalize_fn(images)
        _, logits = model(images)
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        m = mask.float()
        return ((nll * m).sum(), m.sum(),
                confusion_matrix_t(logits, labels, n_cls, mask))

    return step
