"""Epoch loops: one training epoch, full-split evaluation.

Counterpart of moma_tpu/train/loop.py (`train_one_epoch` :34-129,
`evaluate` :132-157).  Host batches (numpy uint8 from
moma_tpu_torch.data.pipeline.Loader) move to the run's device; step metrics stay
on the device and are fetched at print points and once at epoch end.  An
epoch can start mid-way (`start_step`, for a resume from a preemption
save) and stops between steps when its `stop` guard is set.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from moma_tpu_torch.core.metrics import EvalAccumulator, Meter


class NonFiniteLossError(RuntimeError):
    """Raised by train_one_epoch when a sync point sees NaN/Inf loss."""


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def step_generator(base_seed: int, epoch: int, i: int) -> torch.Generator:
    """The per-step CPU generator (moma_tpu folds epoch*1_000_003 + i into
    its base key the same way)."""
    return torch.Generator().manual_seed(
        (base_seed * 2 ** 32 + epoch * 1_000_003 + i) % 2 ** 63)


def train_one_epoch(state, loader, step_fn: Callable, device: torch.device,
                    epoch: int, base_seed: int, print_freq: int = 100,
                    log_fn: Optional[Callable] = None, stop=None,
                    start_step: int = 0):
    """Runs one epoch; returns (state, {'loss','acc1','acc5','ips',
    'batch_times', 'steps', ...}).  batch_times are host seconds per step;
    a step's device work is only waited for at print points, so use
    print_freq=1 for per-step times that include it.

    `stop` (core.preempt.GracefulStop) ends the epoch between steps when
    set; 'steps' counts the epoch's batches run in total, so the runner
    can save an exact resume point.  `start_step` resumes mid-epoch: the
    loader skips the first `start_step` batches of its seeded order and
    the per-step generators continue at the same indices, so the finished
    epoch equals the uninterrupted one.  `log_fn(step=, loss=, acc1=)` is
    called at print points (StatsWriter.scalar)."""
    loader.set_epoch(epoch)
    loader.set_start_batch(start_step)
    meters = {k: Meter() for k in ("loss", "acc1", "acc5", "batch_time",
                                   "data_time")}
    bs = loader.batch_size
    sums = None
    n_steps = 0
    batch_times = []
    t0 = time.perf_counter()
    for i, batch in enumerate(loader, start=start_step):
        if stop is not None and stop.stopping:
            break
        t1 = time.perf_counter()
        meters["data_time"].update(t1 - t0)
        b = to_device(batch, device)
        state, metrics = step_fn(state, b, step_generator(base_seed, epoch, i))
        contrib = torch.stack([metrics["loss"].detach().float(),
                               metrics["acc1"].float(),
                               metrics["acc5"].float()])
        sums = contrib if sums is None else sums + contrib
        n_steps += 1
        if (i + 1) % print_freq == 0 or (i + 1) == len(loader):
            vals = contrib.tolist()
            for k, v in zip(("loss", "acc1", "acc5"), vals):
                meters[k].update(v, bs)
            if not np.isfinite(meters["loss"].val):
                raise NonFiniteLossError(
                    f"non-finite loss {meters['loss'].val} at epoch {epoch} "
                    f"step {i + 1}")
            if log_fn is not None:
                log_fn(step=state.step, loss=meters["loss"].val,
                       acc1=meters["acc1"].val)
        t0 = time.perf_counter()
        meters["batch_time"].update(t0 - t1)
        batch_times.append(t0 - t1)
    if sums is not None:
        loss_avg, acc1_avg, acc5_avg = (sums / n_steps).tolist()
    else:
        loss_avg = acc1_avg = acc5_avg = 0.0
    return state, {
        "loss": loss_avg, "acc1": acc1_avg, "acc5": acc5_avg,
        "batch_time": meters["batch_time"].avg,
        "data_time": meters["data_time"].avg,
        "ips": bs / max(meters["batch_time"].avg, 1e-9),
        "batch_times": batch_times,
        "steps": start_step + n_steps,
    }


def evaluate(model: torch.nn.Module, loader, eval_step: Callable,
             device: torch.device, n_cls: int) -> Dict[str, float]:
    """Full-split evaluation: loss, top-1 and macro-F1 from one global
    confusion matrix, accumulated on the device and fetched once."""
    model.eval()
    acc = EvalAccumulator(n_cls=n_cls)
    tot = None
    for batch in loader:
        b = to_device({k: batch[k] for k in ("image", "label", "mask")},
                      device)
        loss_sum, n, cm = eval_step(model, b)
        if tot is None:
            tot = [loss_sum, n, cm]
        else:
            tot = [tot[0] + loss_sum, tot[1] + n, tot[2] + cm]
    if tot is not None:
        acc.update(float(tot[0]), float(tot[1]), tot[2].cpu().numpy())
    return {"loss": acc.loss, "acc": acc.acc, "f1": acc.f1,
            "conf_mat": acc.conf_mat.tolist(), "n": acc.n}
