"""Tracing / profiling hooks.

Counterpart of moma_tpu/core/profiling.py over `torch.profiler`:

  * StepTimer       — EMA'd step/data times + images/sec (:20)
  * trace()         — context manager that records a torch.profiler trace
                      and writes it as a Chrome trace (JSON) into `logdir`
  * summarize_trace — device time per operation name from a written trace
                      (:79); `trace_summary` adds the device's busy time
                      and idle share (`device_busy`), which
                      cli/profile_step.py reports
  * memory_stats()  — live per-device memory (:118)

The trace file is read back with the json module only: one parser for
every consumer.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

# the trace categories of work that ran on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_US = 10.0


class StepTimer:
    """Low-overhead step timing with EMA; call boundaries from the host
    loop.  CUDA launches are asynchronous, so wall times reflect the
    pipeline: synchronize at sample points for true device step time."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.step_time: Optional[float] = None
        self.data_time: Optional[float] = None
        self._t_last = None
        self._t_data = None

    def data_start(self):
        self._t_data = time.perf_counter()

    def step_start(self):
        now = time.perf_counter()
        if self._t_data is not None:
            d = now - self._t_data
            self.data_time = (
                d if self.data_time is None
                else self.ema * self.data_time + (1 - self.ema) * d
            )
        self._t_last = now

    def step_end(self, batch_size: int = 0) -> Dict[str, float]:
        now = time.perf_counter()
        dt = now - self._t_last if self._t_last is not None else 0.0
        self.step_time = (
            dt if self.step_time is None
            else self.ema * self.step_time + (1 - self.ema) * dt
        )
        out = {"step_time": self.step_time, "data_time": self.data_time or 0.0}
        if batch_size and self.step_time:
            out["ips"] = batch_size / self.step_time
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """Record host operations and, with a CUDA device, its kernels, copies
    and memsets; on exit write `<logdir>/trace_<time>_<pid>.json`:

        with profiling.trace('build/trace'):
            for _ in range(10): state, m = step(state, batch, g)
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{int(time.time())}_{os.getpid()}.json"))


def _trace_file(path: str) -> str:
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.json")),
                       key=os.path.getmtime)
        if not files:
            raise FileNotFoundError(f"no trace under {path}")
        return files[-1]
    return path


def device_events(path: str) -> Tuple[list, bool]:
    """(complete events of the device, True) from a Chrome trace file or
    the newest one in a directory; (host operator events, False) when the
    trace holds no device work (a CPU run)."""
    with open(_trace_file(path)) as f:
        events = json.load(f).get("traceEvents", [])
    done = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in done if e.get("cat") in DEVICE_CATS]
    if dev:
        return dev, True
    return [e for e in done if e.get("cat") == "cpu_op"], False


def _by_name(events, top: int) -> List[Tuple[str, float, int]]:
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        name = e.get("name", "?")
        agg[name] += float(e.get("dur", 0.0))
        cnt[name] += 1
    return [(name, dur / 1000.0, cnt[name])
            for name, dur in agg.most_common(top)]


def summarize_trace(logdir: str,
                    top: int = 25) -> List[Tuple[str, float, int]]:
    """[(name, total_ms, count)] of the trace's device work, most time
    first; host operators when no device work was recorded."""
    return _by_name(device_events(logdir)[0], top)


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


def trace_summary(path: str, top: int = 100) -> dict:
    """device_busy over the trace's device work, its number of intervals
    and the top names by device time (ms)."""
    events, on_device = device_events(path)
    dev = events if on_device else []
    out = device_busy((e["ts"], e.get("dur", 0.0)) for e in dev)
    out["device_intervals"] = len(dev)
    out["top_kernels_ms"] = [[n[:120], ms] for n, ms, _ in
                             _by_name(dev, top)]
    return out


def memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device: memory in use, its peak and the card's size, GiB."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": s.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gb": s.get("allocated_bytes.all.peak", 0) / 2**30,
            "bytes_limit_gb":
                torch.cuda.get_device_properties(i).total_memory / 2**30,
        }
    return out
