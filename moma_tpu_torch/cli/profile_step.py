"""Profile the MoMA training step: step time, phase times, device idle share.

    python -m moma_tpu_torch.cli.profile_step --out build/profile \
        --distill moma --dataset prostate_hv --model_s effiB0 \
        --model_t effiB0 --image_size 512 --batch_size 64 --nce_k 16384 \
        --feat_dim 512 --head mlp --attn self -c 1 -d 1 -b 1

Takes train_student's flags (--device defaults to cuda) plus --out; with
`--mem MoCoAtt --attn all` in place of `--attn self` it profiles the
MoCoAtt step, whose attention over 2B+K tokens runs the flash-attention
kernels (they show by name among the trace's top kernels), and with
`--fused_teacher on` the step whose teacher forwards run the fused
EfficientNet forward (its `teacher_forward` phase is then that forward).
With a teacher of another architecture (`--model_t vit_small_patch16_224
--image_size 224`, config #5) it profiles the cross-arch (EmaTec) step:
`teacher_forward` is then the fixed teacher's eval-mode forward, and a
`momentum_forward` phase times the EMA copy's train-mode forward.  It
builds the run's state with random weights, fixes one synthetic batch
(data loading is set-up, not step time) and runs the steady-state step
(train-BN teacher KL forward):

  1 step time   : STEPS steps after WARMUP, each ending in a device
                  sync; median, min, max on the host clock
  2 phases      : augmentation, one teacher forward (cross-arch: also
                  the momentum forward) and the student forward +
                  backward, each timed alone (CUDA events, median of
                  PHASE_ITERS = 5); the rest of the step is heads, queue,
                  losses, EMA and SGD
  3 trace       : torch.profiler over PROFILE_STEPS steps; the device
                  idle share is 1 - (union of kernel, memcpy and memset
                  intervals) / (first start to last end), and the top
                  operators and kernels by device time.  The profiler's
                  own host work stretches the steps it records, so the
                  summary also gives 1 - (device busy per profiled step)
                  / (median unprofiled step): `idle_share_vs_step`

Writes `<out>/moma_step_trace.json` (the Chrome trace),
`<out>/profile_ops.txt` (the operator table) and
`<out>/profile_summary.json`, whose content it also prints as the last
line.  On the CPU it runs (at a small size) but has no device intervals,
so the idle share is reported as None.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.core.profiling import trace_summary
from moma_tpu_torch.data.pipeline import synthetic_dataset
from moma_tpu_torch.losses.functional import cross_entropy
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import to_device
from moma_tpu_torch.train.moma import (build_state, make_moma_train_step,
                                       make_teacher_forward, module_forward)
from moma_tpu_torch.train.teacher import augment_fns

WARMUP, STEPS, PROFILE_STEPS = 3, 5, 2
PHASE_ITERS = 5   # timed calls of each phase, after one warm-up call


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _phase_ms(fn, device):
    """Median time of fn(): CUDA events on a card, host clock on the CPU."""
    fn()
    _sync(device)
    times = []
    for _ in range(PHASE_ITERS):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None):
    p = argparse.ArgumentParser("moma_tpu_torch profile_step")
    p.add_argument("--out", default="build/profile")
    a, rest = p.parse_known_args(argv)
    cfg = parse_student_args(rest)
    device = resolve_device(cfg.run.device)
    os.makedirs(a.out, exist_ok=True)

    B, S = cfg.data.batch_size, cfg.data.image_size
    state = build_state(cfg, device, steps_per_epoch=100, seed=cfg.run.seed)
    augment = augment_fns(cfg)[0]
    cross_arch = state.ema is not None
    step = make_moma_train_step(cfg, augment, kl_train_bn_override=True,
                                cross_arch=cross_arch)
    data = synthetic_dataset(B, S, cfg.model_s.n_cls, seed=cfg.run.seed)
    batch = to_device({"image": data.images, "label": data.labels}, device)
    gen = torch.Generator().manual_seed(cfg.run.seed)

    for _ in range(WARMUP):
        state, m = step(state, batch, gen)
    _sync(device)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"profiled step gave a non-finite loss {loss}")

    images = augment(batch["image"], gen)
    labels = batch["label"].long()

    teacher_forward = (module_forward if cross_arch
                       else make_teacher_forward(cfg))

    def teacher_fwd():
        # cross-arch: the fixed teacher's eval-mode forward
        with torch.no_grad():
            teacher_forward(state.teacher, images, not cross_arch)

    def momentum_fwd():
        with torch.no_grad():
            module_forward(state.ema, images, True)

    def student_fwd_bwd():
        state.student.train()
        state.student.zero_grad(set_to_none=True)
        _, logits = state.student(images)
        cross_entropy(logits, labels).backward()

    phases = {"augment": _phase_ms(lambda: augment(batch["image"], gen),
                                   device),
              "teacher_forward": _phase_ms(teacher_fwd, device),
              "student_forward_backward": _phase_ms(student_fwd_bwd, device)}
    if cross_arch:
        phases["momentum_forward"] = _phase_ms(momentum_fwd, device)
    state.student.zero_grad(set_to_none=True)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            state, m = step(state, batch, gen)
        _sync(device)
    trace = os.path.join(a.out, "moma_step_trace.json")
    prof.export_chrome_trace(trace)
    avgs = prof.key_averages()
    sort = ("self_device_time_total"
            if avgs and hasattr(avgs[0], "self_device_time_total")
            else "self_cpu_time_total")
    with open(os.path.join(a.out, "profile_ops.txt"), "w") as f:
        f.write(avgs.table(sort_by=sort, row_limit=40))

    step_ms = statistics.median(times)
    tr = trace_summary(trace)
    busy_ms = tr["busy_us"] / 1e3 / PROFILE_STEPS
    summary = {
        "batch": B, "image_size": S, "device": str(device),
        "mem": cfg.moma.mem, "attn": cfg.moma.attn,
        "fused_teacher": cfg.moma.fused_teacher,
        "model_s": cfg.model_s.name, "model_t": cfg.model_t.name,
        "cross_arch": cross_arch,
        "step_ms": {"median": step_ms, "min": min(times),
                    "max": max(times), "n": len(times)},
        "img_per_s": B / (step_ms / 1e3),
        "phase_ms": phases,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if device.type == "cuda" else None),
        "profiled_steps": PROFILE_STEPS,
        "device_busy_ms_per_step": busy_ms,
        "idle_share_vs_step": (1.0 - busy_ms / step_ms
                               if tr["idle_share"] is not None else None),
        "trace": tr,
    }
    with open(os.path.join(a.out, "profile_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
