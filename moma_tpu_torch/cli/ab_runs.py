"""Compare checkouts of the repository on one card, in turns.

    python -m moma_tpu_torch.cli.ab_runs --out chiprun_out/ab \
        build/parent . . build/parent

For each directory in the order given (parent, change, change, parent
keeps drift in the card's clocks out of the difference), from that
directory: chip_smoke.py's flash-attention phase (the three kernels against
their plain versions at (4, 16512, 128) float32, with their times and the
library's), its BatchNorm phase (the two channel-sum kernels at
chip_smoke.BN_SHAPES, with the library's time at the second shape), its
fused-EfficientNet kernel phase (K1 / K2 / K4 at the 16 effiB0@512 block
shapes, with their sums over one forward) and its fused-forward phase (the
fused against the module teacher forward); and this checkout's
chip_smoke.py phases on that directory's code: phase_ra_kernel (the
RandAugment layer at (64, 3, 512, 512) bf16, the random-ops case and one
case per op class beside their bounds), phase_augment_launches (the device
operations of one main-path augment, from a profiler trace) and
phase_bn_forward (channel_sums summed over the 49 BatchNorm inputs of one
effiB0@512 batch-64 forward).  Every directory's phases time with this
checkout's chip_smoke.cuda_time_ms, so all turns' kernel times are
measured the same way; after a `[timer]` line, the BN, RandAugment and
fused-kernel phases again with the host's work in the times (SPIN_CYCLES =
0, how the timer measured before its spin).  Then `cli/profile_step.py`
with chip_smoke.py's effiB0@512 flags for `--mem MoCoAtt --attn all`,
`--attn dual`, `--mem MoCo` and `--mem MoCo --fused_teacher on`, and with
its cross-arch flags (CROSS_ARGS: ViT-S/16 teacher, effiB0 student, 224^2,
batch 64, `--mem MoCo`).  `--configs` picks the profiled configurations
(a checkout older than the cross-arch port has no `cross_arch`), and
`--steps_only` skips the kernel phases.  Each run is a process of its
own; the kernels are built once per directory.
Writes `<out>/ab_runs.json` (every run's kernel lines and profile summary,
its augment phase time included) and prints one line per run.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

KERNELS = ("import sys; sys.path.insert(0, '.'); import chip_smoke as c; "
           # this checkout's chip_smoke: its timer for every directory's
           # phases, and its RandAugment, augment and phase_bn_forward
           # phases on the directory's code
           "import importlib.util as u; "
           "s = u.spec_from_file_location('smoke', sys.argv[1]); "
           "m = u.module_from_spec(s); s.loader.exec_module(m); "
           "c.cuda_time_ms = m.cuda_time_ms; "
           "print('[card]', c.phase_device()); c.phase_build(); "
           "c.phase_flash_kernels({}); c.phase_bn_kernels({}); "
           "m.phase_ra_kernel({}); m.phase_augment_launches(); "
           "c.phase_fe_kernels({}); c.phase_fe_forward(); "
           "m.phase_bn_forward(); "
           # the BN, RandAugment and fused kernels again, timed with the
           # host's work in (how the timer measured before its spin)
           "m.SPIN_CYCLES = 0; print('[timer] host work in', flush=True); "
           "c.phase_bn_kernels({}); m.phase_ra_kernel({}); "
           "c.phase_fe_kernels({}); m.phase_bn_forward()")
SMOKE = str(Path(__file__).resolve().parents[2] / "chip_smoke.py")
# the kernels whose device time per step the trace reports; the RandAugment
# layer's are ra_stats_kernel and ra_main_kernel, in the staged design it
# replaced init_stats and the *_stage kernels
TRACED = re.compile(r"flash_\w+_kernel|k[124]_kernel|(?:grad_)?sums_partial"
                    r"|ra_\w+_kernel|init_stats"
                    r"|(?:entry|lut|enhance|sharp|warp|final)_stage")


def _configs():
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    # profile_step makes its own synthetic batch and runs a fixed number of
    # steps: the CLI's data and epoch flags are not its own
    drop = {"--print_freq": 1, "--epochs": 1, "--synthetic": 0}

    def profile_args(args):
        out, skip = [], 0
        for a in args:
            if skip:
                skip -= 1
            elif a in drop:
                skip = drop[a]
            else:
                out.append(a)
        return out

    base = profile_args(chip_smoke.MOCOATT_ARGS)
    swap = {"all": "dual"}
    moco = [{"MoCoAtt": "MoCo", "all": "self"}.get(a, a) for a in base]
    return {"mocoatt_all": base,
            "mocoatt_dual": [swap.get(a, a) for a in base],
            "moco": moco,
            "moco_fused": moco + ["--fused_teacher", "on"],
            "cross_arch": profile_args(chip_smoke.CROSS_ARGS)}


def _run(cmd, cwd, timeout):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} in {cwd} failed "
                           f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def main(argv=None):
    p = argparse.ArgumentParser("moma_tpu_torch ab_runs")
    p.add_argument("--out", default="build/ab")
    p.add_argument("--configs", default="mocoatt_all,mocoatt_dual,moco,"
                   "moco_fused,cross_arch",
                   help="comma-separated profile_step configurations")
    p.add_argument("--steps_only", action="store_true",
                   help="profile the steps only, no kernel phases")
    p.add_argument("dirs", nargs="+")
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    known = _configs()
    configs = {n: known[n] for n in a.configs.split(",")}
    runs = []
    for i, d in enumerate(a.dirs):
        d = os.path.abspath(d)
        out = ("" if a.steps_only
               else _run([sys.executable, "-c", KERNELS, SMOKE], d, 1500))
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("[kernels] flash", "[kernels] library",
                                   "[kernels] channel_sums",
                                   "[kernels] grad_channel_sums",
                                   "[kernels] k1_expand_stats",
                                   "[kernels] k2_depthwise",
                                   "[kernels] k4_project",
                                   "[kernels] ra_layer", "[augment]",
                                   "[forward] bf16", "[device]", "[card]",
                                   "[timer]"))]
        run = {"dir": d, "turn": i, "kernels": lines, "steps": {}}
        for line in lines:
            print(f"[ab] turn {i} {d}: {line}", flush=True)
        for name, args in configs.items():
            prof_dir = os.path.join(d, "build", f"ab_profile_{i}_{name}")
            out = _run([sys.executable, "-m",
                        "moma_tpu_torch.cli.profile_step", "--out", prof_dir,
                        *args], d, 900)
            summary = json.loads(out.strip().splitlines()[-1])
            run["steps"][name] = summary
            kernels = {}
            for n, ms in summary["trace"]["top_kernels_ms"]:
                m = TRACED.search(n)
                if m:   # device ms per step over the profiled steps
                    kernels[m.group(0)] = (kernels.get(m.group(0), 0.0)
                                           + ms / summary["profiled_steps"])
            print(f"[ab] turn {i} {d}: {name} step "
                  f"{summary['step_ms']['median']:.2f} ms (min "
                  f"{summary['step_ms']['min']:.2f}, max "
                  f"{summary['step_ms']['max']:.2f}), augment "
                  f"{summary['phase_ms']['augment']:.3f} ms, busy "
                  f"{summary['device_busy_ms_per_step']:.2f} ms, idle "
                  f"{summary['idle_share_vs_step']:.4f}, peak "
                  f"{summary['peak_mem_gib']:.2f} GiB; kernels per step "
                  f"(ms) {kernels}", flush=True)
        runs.append(run)
        with open(os.path.join(a.out, "ab_runs.json"), "w") as f:
            json.dump(runs, f, indent=1)
    return runs


if __name__ == "__main__":
    main(sys.argv[1:])
