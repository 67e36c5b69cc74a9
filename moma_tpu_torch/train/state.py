"""MoMA train state and the SGD optimizer.

Counterpart of moma_tpu/train/state.py: `MomaState` (:95-128) and
`make_sgd` (:131-169).  JAX's immutable state becomes a container of live
modules that the step updates in place: the student and teacher backbones,
in cross-arch (EmaTec) runs the EMA copy of the student (JAX's
`ema_params` / `ema_batch_stats`, train/moma.py:1257-1267), the CMO heads,
the queue, the optimizer and the step count.

`make_sgd` applies the chain of the optax one (state.py:131-175): with
neither `grad_clip` nor `trust_ratio` it is torch.optim.SGD, which does
the same thing: coupled weight decay added to the gradient, then
heavy-ball momentum (the first step's buffer is the gradient itself),
then the learning rate.  With either, `ChainSGD` runs optax's full chain
in its order: clip by the global norm, coupled decay, LARS trust-ratio
scaling of the tensors with ndim > 1, the momentum trace (nesterov as
optax's), the learning rate.  The learning rate is set before every step
from `schedule(step)`.

The trainable set follows the JAX optimizer's tree, which holds all of
`params['cmo']`.  The key head (same-arch embed_t, cross-arch embed_ema)
stays out of the optimizer: it is EMA-tracked from embed_s, and the JAX
step overwrites whatever SGD did to it (train/moma.py:667-690).  In
cross-arch runs embed_t is no key head: it stays in the SGD chain with a
zero gradient, so weight decay and momentum shrink it every step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from moma_tpu_torch.moma.cmo import CMOHeads
from moma_tpu_torch.moma.queue import QueueState


class ChainSGD(torch.optim.Optimizer):
    """optax's clip_by_global_norm -> add_decayed_weights -> masked
    scale_by_trust_ratio (ndim > 1) -> trace -> scale_by_learning_rate, on
    tensor lists.  The global norm spans every parameter group, as the
    optax chain spans the whole parameter tree."""

    def __init__(self, params, momentum: float, weight_decay: float,
                 nesterov: bool, grad_clip: float, trust_ratio: float):
        super().__init__(list(params), dict(
            lr=0.0, momentum=momentum, weight_decay=weight_decay,
            nesterov=nesterov, grad_clip=grad_clip, trust_ratio=trust_ratio))

    @torch.no_grad()
    def step(self, closure=None):
        groups = [(g, [p for p in g["params"] if p.grad is not None])
                  for g in self.param_groups]
        clip = self.param_groups[0]["grad_clip"]
        if clip > 0:
            grads = [p.grad for _, ps in groups for p in ps]
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            # optax: select(norm < c, g, g / norm * c), no host sync
            keep = norm < clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * clip))
        for group, params in groups:
            if not params:
                continue
            upd = [p.grad.clone() for p in params]
            if group["weight_decay"] > 0:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            if group["trust_ratio"] > 0:
                idx = [i for i, p in enumerate(params) if p.ndim > 1]
                if idx:
                    ps = [params[i] for i in idx]
                    us = [upd[i] for i in idx]
                    pn = torch.stack(torch._foreach_norm(ps))
                    un = torch.stack(torch._foreach_norm(us))
                    ratio = group["trust_ratio"] * pn / un
                    ratio = torch.where((pn == 0) | (un == 0),
                                        torch.ones_like(ratio), ratio)
                    torch._foreach_mul_(us, list(ratio.unbind()))
            m = group["momentum"]
            if m > 0:
                bufs = []
                for p, u in zip(params, upd):
                    st = self.state[p]
                    if "momentum_buffer" not in st:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    bufs.append(st["momentum_buffer"])
                # trace = g + m * trace
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, upd)
                if group["nesterov"]:
                    upd = torch._foreach_add(upd, torch._foreach_mul(bufs, m))
                else:
                    upd = bufs
            torch._foreach_add_(params, upd, alpha=-group["lr"])
        return None


def make_sgd(params: Iterable[nn.Parameter], momentum: float = 0.9,
             weight_decay: float = 5e-4, nesterov: bool = False,
             grad_clip: float = 0.0,
             trust_ratio: float = 0.0) -> torch.optim.Optimizer:
    # the learning rate is set per step from the schedule (train/moma.py)
    if grad_clip > 0 or trust_ratio > 0:
        return ChainSGD(params, momentum, weight_decay, nesterov, grad_clip,
                        trust_ratio)
    return torch.optim.SGD(list(params), lr=0.0, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


@dataclass
class MomaState:
    """Everything a MoMA step reads and updates (in place)."""

    student: nn.Module
    # same-arch: the momentum encoder, EMA'd from the student; cross-arch:
    # the fixed KL teacher
    teacher: nn.Module
    heads: CMOHeads
    queue: QueueState
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    # cross-arch only: the momentum encoder, an EMA copy of the student with
    # its own BN running statistics
    ema: Optional[nn.Module] = None

    def trainable_params(self):
        """Parameters the optimizer updates: student, embed_s, in cross-arch
        runs embed_t (zero gradient), and the attention set."""
        yield from self.student.parameters()
        yield from self.heads.embed_s.parameters()
        if self.ema is not None:
            yield from self.heads.embed_t.parameters()
        yield from self.heads.attn.parameters()
