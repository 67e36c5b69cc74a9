"""Epoch loops: one training epoch, full-split evaluation, and the run's
epochs around them.

Counterpart of moma_tpu/train/loop.py (`train_one_epoch` :34-129,
`evaluate` :132-157).  Host batches (numpy uint8 from
moma_tpu_torch.data.pipeline.Loader; a packed batch's image comes already
copied to the card from pinned memory) move to the run's device; step
metrics stay on the device and are fetched at print points and once at
epoch end.  An
epoch can start mid-way (`start_step`, for a resume from a preemption
save) and stops between steps when its `stop` guard is set.

Data-parallel (core/mesh.py): every rank runs the same epochs on its
rows of the same global batches.  A stop is agreed over the ranks
(core/preempt.AgreedStop) at each step boundary and at the epoch's end,
so no rank leaves the loop while another waits in a collective; the
step's metrics are already averaged over the ranks, so the NaN guard sees
the same loss everywhere.  Evaluation sums each rank's loss, count and
confusion matrix with one all_reduce, which keeps the masked counts of the
padded tail exact.  Rank 0 writes the checkpoints and stat files (the
others wait at a barrier); every rank reads `latest` on --resume.

`resume_point` and `run_epochs` are the part the three training runs
share (moma_tpu/train/teacher.py:166-305, student.py:176-363,
moma.py:1440-1640, which repeat it): the resume point read from `latest`
and its meta files, then per epoch the (optionally traced) training
epoch, the NaN guard, the preemption save, the val / test evaluation, the
stat files, the `latest` / `best_acc` / `best_f1` checkpoints, and at the
end `parameters.json`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from moma_tpu_torch.core.mesh import data_axis, is_main
from moma_tpu_torch.core.metrics import EvalAccumulator, Meter
from moma_tpu_torch.core.preempt import AgreedStop, GracefulStop
from moma_tpu_torch.core.profiling import trace


class NonFiniteLossError(RuntimeError):
    """Raised by train_one_epoch when a sync point sees NaN/Inf loss."""


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays on `device`; a tensor the Loader already put
    there (a packed batch's image on a CUDA run) stays as it is."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device,
                                                         non_blocking=True)
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
    'batch_times', 'data_times', 'steps', ...}).  batch_times are host
    seconds per step, data_times the host seconds each step waited for its
    batch;
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
    agreed = AgreedStop(stop, device) if stop is not None else None
    meters = {k: Meter() for k in ("loss", "acc1", "acc5", "batch_time",
                                   "data_time")}
    bs = loader.batch_size
    sums = None
    n_steps = 0
    batch_times, data_times = [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(loader, start=start_step):
        if agreed is not None and agreed.poll():
            break
        t1 = time.perf_counter()
        meters["data_time"].update(t1 - t0)
        data_times.append(t1 - t0)
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
        "batch_times": batch_times, "data_times": data_times,
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
        # the ranks' sums: every rank then holds the split's metrics
        data_axis().sum_(tot)
        acc.update(float(tot[0]), float(tot[1]), tot[2].cpu().numpy())
    return {"loss": acc.loss, "acc": acc.acc, "f1": acc.f1,
            "conf_mat": acc.conf_mat.tolist(), "n": acc.n}


def resume_point(cfg, ckpt):
    """(saved state or None, start_epoch, resume_step, best_acc, best_f1)
    of a run: with --resume and a complete `latest`, its state, the epoch
    after it, the exact batch of a preemption save, and the best-metric
    thresholds read back from their meta files (else the first epoch after
    the restart would overwrite the real best checkpoints)."""
    if not (cfg.run.resume and ckpt.exists("latest")):
        return None, 1, 0, -1.0, -1.0
    saved = ckpt.restore("latest")
    meta = ckpt.meta("latest") or {}
    start_epoch = int(meta.get("epoch", 0)) + 1
    resume_step = int(meta.get("resume_step", 0))
    best_acc = float((ckpt.meta("best_acc") or {}).get("val_acc", -1.0))
    best_f1 = float((ckpt.meta("best_f1") or {}).get("val_f1", -1.0))
    print(f"[resume] from epoch {start_epoch}"
          + (f" step {resume_step}" if resume_step else "")
          + f" (best_acc={best_acc:.2f}, best_f1={best_f1:.4f})", flush=True)
    return saved, start_epoch, resume_step, best_acc, best_f1


def run_epochs(cfg, state, *, epoch_step: Callable, evaluate_fn: Callable,
               full_state: Callable, train_loader, device, ckpt, stats,
               run_dir: str, start, stop=None, test_loss: bool = False,
               params: Optional[dict] = None, line: str = "loss"):
    """Epochs start[0]..cfg.run.epochs of a run; returns (state, {'best_acc',
    'best_f1', 'train', 'val', 'epochs', 'run_dir'}, plus 'preempted' or
    'nan_aborted' when the run stopped early).

    `epoch_step(ep_start)` gives the step function of an epoch that starts
    at batch `ep_start`; `evaluate_fn(state, split)` evaluates on 'val' or
    'test'; `full_state(state)` is the checkpointed dict.  `start` is
    resume_point's (start_epoch, resume_step, best_acc, best_f1).  `stop`
    is a GracefulStop-like guard to use in place of the one installed
    here for SIGTERM / SIGINT.  `test_loss` adds the test loss to the
    epoch's row, `params` to parameters.json; `line` names the train loss
    in the epoch's printed line."""
    start_epoch, resume_step, best_acc, best_f1 = start
    guard = stop if stop is not None else GracefulStop()
    say = print if is_main() else (lambda *a, **k: None)
    t_start = time.time()
    history = []
    tr = val = None

    def result(**extra):
        return state, {"best_acc": best_acc, "best_f1": best_f1, "train": tr,
                       "val": val, "epochs": history, "run_dir": run_dir,
                       **extra}

    try:
        if stop is None:
            guard.__enter__()
        for epoch in range(start_epoch, cfg.run.epochs + 1):
            ep_start = resume_step if epoch == start_epoch else 0
            ctx = (trace(cfg.run.profile_dir)
                   if cfg.run.profile_dir and epoch == start_epoch
                   else contextlib.nullcontext())
            try:
                with ctx:
                    state, tr = train_one_epoch(
                        state, train_loader, epoch_step(ep_start), device,
                        epoch, cfg.run.seed, print_freq=cfg.run.print_freq,
                        log_fn=stats.scalar, stop=guard, start_step=ep_start)
            except NonFiniteLossError as e:
                # 'latest' (the end of the last finite epoch) is the resume
                # point
                say(f"[nan-guard] {e}; stopping — resume from the last "
                      f"epoch-end checkpoint (epoch {epoch - 1})", flush=True)
                stats.update_epoch(epoch, {"nan_aborted": True})
                return result(nan_aborted=True)
            if AgreedStop(guard, device).now():
                # preemption: the full state and the exact batch index, so
                # --resume continues this epoch where it stopped
                ckpt.save("latest", full_state(state),
                          {"epoch": epoch - 1, "preempted": True,
                           "resume_step": tr["steps"]})
                say(f"[preempt] checkpointed at epoch {epoch} step "
                      f"{tr['steps']}/{len(train_loader)}; exiting",
                      flush=True)
                return result(preempted=True)
            val = evaluate_fn(state, "val")
            row = {"train_loss": tr["loss"], "train_acc": tr["acc1"],
                   "ips": tr["ips"], "val_loss": val["loss"],
                   "val_acc": val["acc"], "val_f1": val["f1"]}
            if ep_start:
                # resumed epoch: train stats cover only the tail batches
                row["train_partial_from"] = ep_start
            if not cfg.run.skip_test:
                test = evaluate_fn(state, "test")
                if test_loss:
                    row["test_loss"] = test["loss"]
                row.update(test_acc=test["acc"], test_f1=test["f1"])
            stats.update_epoch(epoch, row)
            history.append({"epoch": epoch, **row})
            say(f"epoch {epoch}: {line} {tr['loss']:.4f} acc "
                  f"{tr['acc1']:.2f} | val acc {val['acc']:.2f} f1 "
                  f"{val['f1']:.4f} | {tr['ips']:.1f} img/s", flush=True)
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
            "config": cfg.to_json(), **(params or {}),
            "best_val_acc": best_acc, "best_val_f1": best_f1,
            "hours": (time.time() - t_start) / 3600.0})
        return result()
    finally:
        # the prior handlers come back, so a later SIGTERM in this process
        # is not swallowed by a dead flag
        if stop is None:
            guard.__exit__()
        stats.close()
