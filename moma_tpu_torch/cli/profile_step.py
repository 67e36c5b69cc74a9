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
EfficientNet forward (its `teacher_forward` phase is then that forward).  It
builds the run's state with random weights, fixes one synthetic batch
(data loading is set-up, not step time) and runs the steady-state step
(train-BN teacher KL forward):

  1 step time   : STEPS steps after WARMUP, each ending in a device
                  sync; median, min, max on the host clock
  2 phases      : augmentation, one teacher forward and the student
                  forward + backward, each timed alone (CUDA events,
                  median of 5); the rest of the step is heads, queue,
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
from collections import defaultdict

import numpy as np
import torch

from moma_tpu_torch.core.config import parse_student_args
from moma_tpu_torch.data.pipeline import synthetic_dataset
from moma_tpu_torch.losses.functional import cross_entropy
from moma_tpu_torch.runtime import resolve_device
from moma_tpu_torch.train.loop import to_device
from moma_tpu_torch.train.moma import (build_state, make_moma_train_step,
                                       make_teacher_forward)
from moma_tpu_torch.train.teacher import augment_fns

WARMUP, STEPS, PROFILE_STEPS = 3, 5, 2
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_US = 10.0


def device_busy(intervals):
    """(start_us, dur_us) pairs -> {'busy_us', 'span_us', 'idle_share',
    'largest_gap_us', 'gaps_over_10us'} over the union of the intervals;
    idle_share is None when there is no interval."""
    iv = sorted((float(s), float(s) + float(d)) for s, d in intervals)
    if not iv:
        return {"busy_us": 0.0, "span_us": 0.0, "idle_share": None,
                "largest_gap_us": 0.0, "gaps_over_10us": 0}
    busy, largest, n_gaps = 0.0, 0.0, 0
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gap = s - cur_e
            largest = max(largest, gap)
            n_gaps += gap > GAP_US
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = cur_e - iv[0][0]
    return {"busy_us": busy, "span_us": span,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0,
            "largest_gap_us": largest, "gaps_over_10us": n_gaps}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _phase_ms(fn, device, iters=5):
    """Median time of fn(): CUDA events on a card, host clock on the CPU."""
    fn()
    _sync(device)
    times = []
    for _ in range(iters):
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


def _trace_summary(path, top=100):
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.get("name", "?")] += float(e.get("dur", 0.0))
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = device_busy((e["ts"], e.get("dur", 0.0)) for e in dev)
    out["device_intervals"] = len(dev)
    out["top_kernels_ms"] = [[n[:120], us / 1e3] for n, us in kernels]
    return out


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
    step = make_moma_train_step(cfg, augment, kl_train_bn_override=True)
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

    teacher_forward = make_teacher_forward(cfg)

    def teacher_fwd():
        with torch.no_grad():
            teacher_forward(state.teacher, images, True)

    def student_fwd_bwd():
        state.student.train()
        state.student.zero_grad(set_to_none=True)
        _, logits = state.student(images)
        cross_entropy(logits, labels).backward()

    phases = {"augment": _phase_ms(lambda: augment(batch["image"], gen),
                                   device),
              "teacher_forward": _phase_ms(teacher_fwd, device),
              "student_forward_backward": _phase_ms(student_fwd_bwd, device)}
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
    tr = _trace_summary(trace)
    busy_ms = tr["busy_us"] / 1e3 / PROFILE_STEPS
    summary = {
        "batch": B, "image_size": S, "device": str(device),
        "mem": cfg.moma.mem, "attn": cfg.moma.attn,
        "fused_teacher": cfg.moma.fused_teacher,
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
