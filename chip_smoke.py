#!/usr/bin/env python3
"""GPU smoke run of moma_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version on the card, then drives the MoMA
student training path (effiB0 student and teacher at 512^2, batch 64,
K=16384, bf16) through its CLI entry point for one epoch of synthetic data,
once with the MoCo memory (`--mem MoCo --attn self`), once with MoCoAtt
(`--mem MoCoAtt --attn all`, attention over 2*64 + 16384 tokens) and once
with `--fused_teacher on` (both teacher forwards through the fused
EfficientNet forward), and checks that every train-mode BatchNorm,
RandAugment layer, many-token attention and fused MBConv block went through
the hand-written kernels; then the run around the step (checkpoints,
--resume, preemption, test_eval, pretrained weights, the resized crop);
then config #5, cross-arch MoMA: a ViT-S/16 teacher and an effiB0 student
at 224^2 in EmaTec mode (CROSS_ARGS); then supervised teacher training
(scripts/run_vanilla.sh's command line, TEACHER_ARGS) and the seven
comparison distillers of scripts/run_comparison.sh from that teacher;
then the CLIs' default run on CIFAR-100 (a resnet32x4 teacher, resnet8x4
kd / crd / MoMA students) and one step of each backbone family.  After the
MoCo path, the data axis: --grad_accum, one rank under NCCL through
torch.distributed.run, and two ranks sharing the card; after the
comparison distillers, the same on two ranks.

    python3 chip_smoke.py          # one CUDA device; exits non-zero on failure

Phases (each prints its own lines):
  1 device     : torch.cuda.is_available() or fail; card name + power limit
  2 build      : nvcc-compile moma_tpu_torch/csrc/*.cu into build/, one
                 nvcc per source, all started together; ptxas's registers
                 and spills per kernel instance and, where the toolkit has
                 cuobjdump, the HMMA (tensor-core) instructions of the flash
                 and fused-EfficientNet kernels; fails if a flash kernel or
                 an instance of K1 / K2 / K4 has none
  3 kernels    : kernel vs plain version at the main paths' shapes, with
                 max error and CUDA-event times (median of 20; of 5 for the
                 flash-attention kernels), the least time the card could
                 take (bound) and, where one PyTorch call computes the same
                 function, that call's time (library; used nowhere in the
                 package; for dq and dk/dv also their share of the
                 library's backward by operations); the BN sums' achieved
                 GB/s at the effiB0@512 and @224 shapes, and channel_sums
                 at the 49 BatchNorm inputs of one effiB0 batch-64 forward
                 at 512^2 and at 224^2, summed beside the summed bound;
                 the three fused-EfficientNet kernels at each of the 16
                 effiB0 block shapes of a 512^2 input, each launch
                 beside its bound (bytes, products, taps; the silu's
                 special-function work shown beside it) and its launch
                 plan, and their sums over one forward; the RandAugment
                 layer per op class beside its bound, with its differing
                 pixels and its kernel launches a layer, at 512^2 and at
                 224^2, and the device operations of one main-path augment
                 (a profiler trace)
  4 forward    : the fused EfficientNet forward against the module forward
                 on the card, same weights: f32 (TF32 off) at 64^2 and
                 512^2, train and eval mode, then bf16 at batch 64, 512^2
                 with both forwards' times
  5 step parity: one MoMA step at 64^2, batch 4, f32 on the CPU (plain
                 versions) and on the card (kernels), same weights and
                 draws; MoCo at K=64, MoCoAtt 'all' at K=2048 (2056 tokens,
                 the streaming route on both devices), MoCo with
                 --fused_teacher on, then cross-arch MoCo with a ViT-S/16
                 teacher (the student and the EMA copy compared)
  6 main paths : `python -m moma_tpu_torch.cli.train_student ...` in-process,
                 MoCo, MoCoAtt, then MoCo with --fused_teacher on; finite
                 losses, queue pointer, launch counts (set to 0 just before
                 each path), step time, img/s, peak memory.  Between MoCo
                 and MoCoAtt the data axis: (a) MoCo with --grad_accum 1, 2
                 and 4 and run_vanilla.sh's step with 1 and 2 (launch
                 counts, step time, peak); (b) after phase 10b, `python -m
                 torch.distributed.run --standalone --nproc_per_node 1` of
                 the MoCo path with --bn local and of run_comparison.sh's
                 crd line, one launcher (NCCL; step losses equal to the
                 runs without a group, rank 0's checkpoints, step time);
                 (c) two ranks sharing the card, each a spawned process in
                 a gloo group: which collectives gloo takes on CUDA
                 tensors, the MoCo path at 32 rows a rank with --bn local
                 and --bn sync (step times, peak, the bytes gathered and
                 reduced a step), and at 64^2 f32 the 2-rank 'local' step
                 against --grad_accum 2 and the 2-rank 'sync' / 'global'
                 steps against one process
 6b packed     : a seeded JPEG tree (imagefolder, 384 train and 64 val
                 images of 600^2) packed by the port at 512^2 and 224^2:
                 the decoder's route (native libjpeg, or PIL where
                 libjpeg's headers are missing), img/s, empty rows, the
                 largest difference from PIL; the host loader at batch 64
                 (numpy gather against the native prefetcher's wait, H2D
                 from pageable and pinned memory); the MoCo main path
                 trained from the pack (--dataset imagefolder
                 --num_workers 8, 6 steps: launch counts, step and data
                 time against the --synthetic run, every batch through the
                 pinned ring); --remat on the main path (196 channel_sums
                 a step, step losses and running statistics against the
                 plain run, time, peak); one effiB0 student step plain /
                 --remat / block_remat (time, peak) and the stem alone with
                 stem_s2d 0 / 2 / 4
  7 persistence: the run around the step at the MoCo path's size, 2 steps
                 an epoch: (a) 1 epoch + --resume against 2 straight epochs
                 (step losses, step count, queue pointer, the best-metric
                 thresholds, every tensor of the final state), with cuDNN's
                 default algorithms and with torch.backends.cudnn.
                 deterministic; (b) latest.pt restored onto the card bit for
                 bit, a checkpoint's size and its save and load times; (c)
                 SIGTERM after step 1, then --resume takes the 3 remaining
                 steps; (d) cli.test_eval against the phase's own eval of
                 best_acc.pt; (e) --std_pre / --tec_pre best_acc.pt; (f) 2
                 steps with --image_resize (launch counts) and the crop's
                 device time a batch beside the augment's; (g) --resume
                 round trips with --fused_teacher on and MoCoAtt 'all'; then
                 2 steps with --profile_dir and the trace's top 5
  8 cross-arch : CROSS_ARGS through the CLI, 4 steps: launch counts (the
                 student's and the EMA copy's train-mode BatchNorms, no
                 flash or fused kernel), the fixed teacher bit for bit
                 unchanged, the EMA copy after one step, step time, img/s,
                 peak memory; a --resume round trip at 1 step an epoch
                 (every tensor, the EMA copy's too); one --mem MoCoST step
                 (memory_s and memory_t rows differ)
  8b MoE       : config #5 with the Mixture-of-Experts teacher
                 (MOE_ARGS: vit_small_moe_patch16_224, 8 experts, top-1,
                 capacity factor 1.25, MoE in the 6 odd blocks), 4 steps:
                 launch counts, step time, img/s, peak, the tokens each MoE
                 block dropped; the MoE teacher trained through
                 cli.train_teacher at 224^2 (MOE_TEACHER_ARGS, 4 steps:
                 gradients through the router's gates).  With phase 12 (in
                 its world): the same run at --model_parallel 2
                 --teacher_parallel expert (TP_RUNS 'expert': 4 of 8
                 experts a rank, one model_all_reduce a MoE block) and the
                 expert-parallel forward at batch 64 against the dense one
                 (f32 with TF32 off and bf16, the dense forward's expert
                 choices replayed)
  9 teacher    : TEACHER_ARGS through cli.train_teacher, 4 steps: launch
                 counts (49 channel_sums and grad_channel_sums a step, 2
                 RandAugment layers, no flash or fused kernel), step time,
                 img/s, peak memory; 2 steps under --profile_dir (device
                 busy and idle share, top 5); its best_acc.pt into one
                 MoMA step (--tec_pre) and one kd step (--path_t), the
                 loaded teacher bit for bit the run's; a --resume round
                 trip; one 64^2 vanilla step on the CPU and the card
 10 comparison : run_comparison.sh's kd, hint, correlation, crd, attention,
                 semckd and simkd (their -c / -d / -b, --path_t phase 9's
                 teacher) through cli.train_student, 4 steps each: launch
                 counts (the student's and the aux modules' train-mode
                 BatchNorms), step time, img/s, peak memory; crd's 2 steps
                 under --profile_dir; then one 64^2 step of each of the 17
                 methods on the CPU and the card
 10b comparison on two ranks: the same seven command lines on two gloo
                 ranks sharing the card (32 rows a rank, 2 steps each, one
                 spawned world): each rank's step times, peak memory,
                 ra_layer / channel_sums / grad_channel_sums a step (every
                 student and aux BN synced), the bytes gathered and
                 reduced a step, the ranks' final states bit for bit; the
                 17 methods' 64^2 f32 step (and crd at --grad_accum 2) on
                 the 2 ranks against one process, TF32 off, to DP_RTOL
 11 zoo / CIFAR: channel_sums / grad_channel_sums at the zoo's 32^2
                 shapes (batch 64; C = 32..256 and the odd 8, 12, 54, 116,
                 216) against their plain versions, and timed at
                 (64,32,32,256) / (64,32,32,64) bf16 beside bound and
                 library; a seeded CIFAR-100 file in the canonical pickle
                 layout at 50000 / 10000 images; resnet32x4 through
                 cli.train_teacher (CIFAR_TEACHER_ARGS, the JAX defaults,
                 4 steps: 34 channel_sums and grad_channel_sums a step, no
                 RandAugment; 2 steps under --profile_dir; a --resume round
                 trip), then resnet8x4 students from its best_acc.pt by
                 --path_t: kd, crd (banks of 50000 rows) and MoMA
                 (cross-arch EmaTec), 4 steps each, the loaded teacher bit
                 for bit; then one full-width batch-64 step of one net per
                 family (ZOO_SWEEP: launches = the net's BatchNorms, every
                 BN input channels_last, ShuffleNets' copies in a profiled
                 step) and each family's step at 32^2 / 64^2, batch 4, f32,
                 on the CPU and the card.
                 Every run writes under a temporary --save_dir, removed at
                 exit
The last three lines of stdout are one JSON object with the per-kernel
results, the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 1140
SAVE_ROOT = ""   # the runs' --save_dir: a temporary directory, removed at exit
TIMING_ITERS = 20
SPIN_CYCLES = 4_000_000   # about 2 ms of a timed call's lead (cuda_time_ms)
MAIN_ARGS = [
    "--distill", "moma", "--dataset", "prostate_hv", "--model_s", "effiB0",
    "--model_t", "effiB0", "--image_size", "512", "--batch_size", "64",
    "--nce_k", "16384", "--feat_dim", "512", "--head", "mlp", "--attn",
    "self", "--mem", "MoCo", "-c", "1", "-d", "1", "-b", "1", "--epochs",
    "1", "--synthetic", "--device", "cuda", "--print_freq", "1",
]
MOCOATT_ARGS = [
    {"MoCo": "MoCoAtt", "self": "all"}.get(a, a) for a in MAIN_ARGS]


def with_flags(args, **flags):
    """A copy of `args` with the given --flag values replaced."""
    out = list(args)
    for k, v in flags.items():
        out[out.index(f"--{k}") + 1] = v
    return out


# config #5 (BASELINE.md:55, tests/test_moma_cross_arch.py): a ViT-S/16
# teacher (dim 384, depth 12, 6 heads, 197 tokens) and an effiB0 student at
# 224^2 in cross-arch EmaTec mode, otherwise the MoCo main path's flags
CROSS_ARGS = with_flags(MAIN_ARGS, model_t="vit_small_patch16_224",
                        image_size="224")
# config #5 with the MoE ViT-S/16 teacher of moma_tpu_torch/models/vit_moe.py
MOE_T = "vit_small_moe_patch16_224"
MOE_ARGS = with_flags(CROSS_ARGS, model_t=MOE_T)
# peaks of one H100 SXM (NVIDIA's data sheet): device memory rate, the
# float32 rate outside the tensor cores (for float32 operands), and the dense
# bf16 tensor-core rate (for products of bf16 operands accumulated in float32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# float32 products on the tensor cores to float32 accuracy: three products
# of the dense TF32 rate (495 TFLOP/s) per float32 product
F32_ON_TF32_FLOPS = 495e12 / 3
# the special-function units (ex2, rcp): 16 results a clock on each of 132
# SMs at the 1.98 GHz boost clock; a silu of float32 internals takes two
# there.  Shown beside a fused kernel's bound, never part of it: the
# exponential can run as a polynomial and the reciprocal as Newton steps on
# the FMA pipes, so the card computes silus faster than this.
SFU_OPS_PER_S = 132 * 16 * 1.98e9
SFU_PER_SILU = 2
FLASH_SHAPE = (4, 2 * 64 + 16384, 128)   # (heads, 2B+K tokens, head dim)
FLASH_SMALL = (4, 333, 32)               # ragged tiles, bf16
FLASH_ITERS = 5
# of the largest entry of the reference: float32 kernel and plain version
# differ in the order of their float32 sums (16512 terms); in bf16 both
# round p and ds to bf16, a few land on the other side of a rounding edge
FLASH_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# effiB0 BatchNorm inputs: the largest and the head's at 512^2 (the main
# paths), then at 224^2 (the cross-arch path: 64*7*7 = 3136 rows of 1280)
BN_SHAPES = [(64, 256, 256, 32), (64, 256, 256, 96), (64, 16, 16, 1280),
             (64, 112, 112, 32), (64, 112, 112, 96), (64, 7, 7, 1280)]
BN_RTOL = 1e-4      # of sum|x| per channel: the bound of an f32 sum's error
RA_SHAPE = (64, 3, 512, 512)
RA_SHAPE_224 = (64, 3, 224, 224)   # the cross-arch path: 448-byte bf16 rows
RA_ATOL = 1.0       # pixels are integers 0..255; the kernel should be exact
RA_FILL = (124.0, 116.0, 104.0)
FUSED_ARGS = MAIN_ARGS + ["--fused_teacher", "on"]
# fused-EfficientNet kernels vs plain, of the largest entry of the reference.
# float32: the two differ in the order of their float32 sums.  bf16: both
# round at the same points, a sum landing on the other side of a rounding
# edge moves an element by one bf16 ulp and one such input can move an
# output by another: 2 ulps at max|ref| = 2^-7 of it.  Sums: of sum|x| (and
# of sum x^2), the bound of an f32 sum's error; in bf16 the elements that
# differ by an ulp add to it.
FE_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
FE_SUM_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
FE_BATCH = {"bfloat16": 64, "float32": 8}
FE_TIMED_BLOCK = 1        # y (64,16,256,256) -> E=96, 128^2 out: the largest
FE_PLAIN_ITERS = 3
# fused forward vs module forward in f32 (the bounds the JAX package holds
# its Pallas path to against its reference) and in bf16 (rounding drift
# through 49 chained BatchNorms, bounded loosely)
FE_FWD_RTOL = 1e-3
FE_FWD_BF16_RTOL = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, iters: int = TIMING_ITERS, spin=None) -> float:
    """Median device time of fn() over `iters` calls, in ms.  Before each
    call the device spins for SPIN_CYCLES (or `spin`), so the host has
    enqueued the start event, fn's launches and the end event before the
    device reaches them: the events time the device's work, not the
    wrappers' host-side work (some 50 us a call, which a step hides behind
    earlier kernels).  With a spin of 0 the events time the host's work
    too, as this timer did before the spin was added."""
    import torch

    spin = SPIN_CYCLES if spin is None else spin
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}: {torch.cuda.get_device_name(0)}")
    return smi[0]


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from moma_tpu_torch.ops import (_build, flash_attention, fused_bn,
                                    fused_effnet, randaugment)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:   # one nvcc per source
        for fut in [pool.submit(m._lib) for m in
                    (flash_attention, fused_bn, fused_effnet, randaugment)]:
            fut.result()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc seconds per library: {_build.build_seconds()})")
    for name in ("bn_sums", "randaugment", "flash_attention",
                 "fused_effnet"):
        for kernel, line in _build.ptxas_report(name).items():
            log(f"[build] {name}: {kernel}: {line}")
    # the flash kernels' shared memory per block and, where the toolkit has
    # cuobjdump, their tensor-core (HMMA) instructions
    lib = flash_attention._lib()
    hmma = _build.sass_counts("flash_attention", "HMMA")
    for i, kernel in enumerate(("flash_fwd_kernel", "flash_dq_kernel",
                                "flash_dkv_kernel")):
        for dtype, tname in ((0, "float"), (1, "bf16")):
            for dp in (32, 128):
                inst = f"{kernel}<{tname}, {dp}>"
                log(f"[build] flash_attention: {inst}: dynamic shared memory "
                    f"{lib.moma_flash_smem_bytes(i, dtype, dp)} bytes, HMMA "
                    f"instructions {hmma.get(inst, 'not counted (no cuobjdump)')}")
    # all three flash kernels run on the tensor cores
    if hmma:
        for kernel in ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel"):
            if not hmma.get(f"{kernel}<float, 128>"):
                raise AssertionError(f"{kernel}<float, 128> has no HMMA "
                                     "instruction")
    # and so do every instance of K1, K2 and K4 of the fused forward
    hmma = _build.sass_counts("fused_effnet", "HMMA")
    for inst, n in sorted(hmma.items()):
        log(f"[build] fused_effnet: {inst}: HMMA instructions {n}")
        if inst.startswith(("k1_kernel", "k2_kernel", "k4_kernel")) and not n:
            raise AssertionError(f"{inst} has no HMMA instruction")
    for kernel in ("k1_kernel", "k2_kernel", "k4_kernel"):
        if hmma and not any(k.startswith(kernel) for k in hmma):
            raise AssertionError(f"no {kernel} instance in fused_effnet")


def phase_bn_kernels(results, dev="cuda", shapes=BN_SHAPES):
    import torch

    from moma_tpu_torch.ops import fused_bn as FB

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"channel_sums": 0.0, "grad_channel_sums": 0.0}
    times = {}
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            mean = x.float().mean((0, 1, 2))
            dims = (0, 1, 2)
            abs_x = x.float().abs().sum(dims)
            abs_dy = dy.float().abs().sum(dims)
            abs_dyxm = (dy.float() * (x.float() - mean)).abs().sum(dims)
            cases = (
                ("channel_sums", lambda: FB.channel_sums(x),
                 lambda: FB.channel_sums_plain(x),
                 (abs_x, (x.float() ** 2).sum(dims))),
                ("grad_channel_sums", lambda: FB.grad_channel_sums(dy, x, mean),
                 lambda: FB.grad_channel_sums_plain(dy, x, mean),
                 (abs_dy, abs_dyxm)),
            )
            for name, kern, plain, bounds in cases:
                got, want = kern(), plain()
                sync(dev)
                rel = 0.0
                for g, w, bound in zip(got, want, bounds):
                    err = (g - w).abs()
                    worst[name] = max(worst[name], float(err.max()))
                    rel = max(rel, float((err / (bound + 1e-6)).max()))
                if not rel <= BN_RTOL:
                    raise AssertionError(
                        f"{name} {shape} {dtype}: error {rel:.3e} of sum|.| "
                        f"exceeds {BN_RTOL}")
                ms = cuda_time_ms(kern)
                plain_ms = cuda_time_ms(plain)
                # each input read once: x, or dy and x
                nbytes = (1 if name == "channel_sums" else 2) * (
                    x.numel() * x.element_size())
                log(f"[kernels] {name} {shape} {str(dtype)[6:]}: "
                    f"max err/sum|.| {rel:.2e}, kernel {ms:.3f} ms "
                    f"({nbytes / ms * 1e-6:.1f} GB/s, "
                    f"{nbytes / ms * 1e3 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s)"
                    f", plain {plain_ms:.3f} ms")
                if shape == shapes[1] and dtype == torch.bfloat16:
                    times[name] = (ms, plain_ms)
            if shape == shapes[1] and dtype == torch.bfloat16:
                # one PyTorch call for the same reduction, on the same
                # memory seen as a channels_last NCHW tensor
                xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
                invstd = torch.rsqrt(x.float().var((0, 1, 2)) + 1e-5)
                weight = torch.ones_like(mean)
                lib = {
                    "channel_sums": cuda_time_ms(
                        lambda: torch.batch_norm_stats(xn, 1e-5)),
                    "grad_channel_sums": cuda_time_ms(
                        lambda: torch.batch_norm_backward_reduce(
                            dyn, xn, mean, invstd, weight, True, True, True)),
                }
                got = torch.batch_norm_backward_reduce(
                    dyn, xn, mean, invstd, weight, True, True, True)
                want = FB.grad_channel_sums_plain(dy, x, mean)
                lib_err = max(float(((g - w).abs() / (b + 1e-6)).max())
                              for g, w, b in zip(got[:2], want,
                                                 (abs_dy, abs_dyxm)))
                if not lib_err <= 1e-3:
                    raise AssertionError(
                        "batch_norm_backward_reduce is not the same "
                        f"function: {lib_err:.2e} of sum|.|")
                nbytes = x.numel() * x.element_size()
                bounds_ms = {"channel_sums": nbytes / HBM_BYTES_PER_S * 1e3,
                         "grad_channel_sums":
                             2 * nbytes / HBM_BYTES_PER_S * 1e3}
                log(f"[kernels] library calls at {shape} bf16: "
                    f"batch_norm_stats {lib['channel_sums']:.3f} ms, "
                    f"batch_norm_backward_reduce "
                    f"{lib['grad_channel_sums']:.3f} ms; bounds (bytes at "
                    f"3.35 TB/s) {bounds_ms['channel_sums']:.3f} / "
                    f"{bounds_ms['grad_channel_sums']:.3f} ms")
            del x, dy
    results["channel_sums"] = {
        "source": "moma_tpu_torch/csrc/bn_sums.cu",
        "replaces": "moma_tpu/ops/fused_bn.py:149",
        "max_abs_err": worst["channel_sums"],
        "ms": times["channel_sums"][0], "plain_ms": times["channel_sums"][1],
        "bound_ms": bounds_ms["channel_sums"], "bound_by": "bytes",
        "library_ms": lib["channel_sums"]}
    results["grad_channel_sums"] = {
        "source": "moma_tpu_torch/csrc/bn_sums.cu",
        "replaces": "moma_tpu/ops/fused_bn.py:162",
        "max_abs_err": worst["grad_channel_sums"],
        "ms": times["grad_channel_sums"][0],
        "plain_ms": times["grad_channel_sums"][1],
        "bound_ms": bounds_ms["grad_channel_sums"], "bound_by": "bytes",
        "library_ms": lib["grad_channel_sums"]}


def bn_forward_shapes(image=512, batch=64):
    """The (N, H, W, C) input of each of the 49 BatchNorms of one effiB0
    forward at image^2, in the order the forward runs them: the stem's, each
    MBConv block's bn1 (blocks with expand conv), bn2 and bn3, the head's."""
    from moma_tpu_torch.models.efficientnet import round_filters

    h = -(-image // 2)
    out = [(batch, h, h, round_filters(32, 1.0))]
    for spec, hin in fe_block_shapes(image):
        E = spec.in_filters * spec.expand
        h = -(-hin // spec.stride)
        if spec.expand != 1:
            out.append((batch, hin, hin, E))
        out += [(batch, h, h, E), (batch, h, h, spec.out_filters)]
    return out + [(batch, h, h, round_filters(1280, 1.0))]


def phase_bn_forward(dev="cuda", image=512, batch=64):
    """channel_sums at the 49 BatchNorm inputs of one effiB0 forward
    (image^2, batch 64, bf16): each distinct shape once against its plain
    version (not timed), then the kernel's and torch.batch_norm_stats'
    times; their sums over the forward beside the summed bound (each input
    read once at 3.35 TB/s).  Inputs under the 50 MB L2 stay there between
    timed launches, as a BatchNorm's input often is after the conv that
    wrote it."""
    import torch

    from moma_tpu_torch.ops import fused_bn as FB

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes = bn_forward_shapes(image, batch)
    if len(shapes) != 49:
        raise AssertionError(f"{len(shapes)} BatchNorms in an effiB0 forward")
    tot = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
    for shape in sorted(set(shapes), key=shapes.index):
        n = shapes.count(shape)
        x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        got, want = FB.channel_sums(x), FB.channel_sums_plain(x)
        xf = x.float()
        rel = max(float(((g - w).abs() / (b + 1e-6)).max()) for g, w, b in
                  zip(got, want, (xf.abs().sum((0, 1, 2)),
                                  (xf * xf).sum((0, 1, 2)))))
        del xf
        if not rel <= BN_RTOL:
            raise AssertionError(f"channel_sums {shape} bf16: error "
                                 f"{rel:.3e} of sum|.| exceeds {BN_RTOL}")
        ms = cuda_time_ms(lambda: FB.channel_sums(x))
        xn = x.permute(0, 3, 1, 2)
        lib_ms = cuda_time_ms(lambda: torch.batch_norm_stats(xn, 1e-5))
        bound = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        for k, v in (("kernel", ms), ("library", lib_ms), ("bound", bound)):
            tot[k] += n * v
        log(f"[kernels] channel_sums forward shape {shape} bf16 x{n}: max "
            f"err/sum|.| {rel:.2e}, kernel {ms:.4f} ms, batch_norm_stats "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound / ms:.1%} of it)")
        del x, xn
    log(f"[kernels] channel_sums summed over one effiB0@{image}^2 batch-"
        f"{batch} bf16 forward's 49 BatchNorms: kernel {tot['kernel']:.3f} "
        f"ms, batch_norm_stats {tot['library']:.3f} ms, bound "
        f"{tot['bound']:.3f} ms (bytes at 3.35 TB/s); loss "
        f"{tot['kernel'] - tot['bound']:.3f} ms a forward")
    return tot


def phase_ra_kernel(results, dev="cuda", shape=RA_SHAPE):
    """ra_layer against its plain version at the main path's shape, (64, 3,
    512, 512) bf16: one op for every image (the 15 ops and the identity;
    gate p 0.75, flip p 0.5), random ops under four gate and flip mixes, and
    one case per op class (all gated off; all Invert, Equalize, Sharpness,
    ShearX, Rotate), each with its count of differing pixels.  Times: the
    random-ops case (gate p 0.5, the main path's mix) and each class case,
    beside its bound, bytes at 3.35 TB/s (x read once and the output written
    once; an image whose op needs a statistic reads x once more), and the
    kernel launches one layer makes, from the wrapper's own count.  Scalar
    vectors are built on the host and copied, as on the main path."""
    import torch

    from moma_tpu_torch.data import randaugment as RA
    from moma_tpu_torch.ops import randaugment as RK
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    dev = torch.device(dev)
    B, _, H, W = shape
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, shape, generator=g).to(dev, torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    worst = 0.0

    def scalars(op, apply, flip_p, d):
        flip = torch.rand(B, generator=g) < flip_p
        return RK.layer_scalars(op, d["mag"], d["sign"], apply, H, RA_FILL,
                                W=W, hflip=flip).to(dev)

    def check(label, scal):
        nonlocal worst
        got = RK.ra_layer(x, scal)
        want = RK.ra_layer_plain(x, scal)
        sync(dev)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = max(worst, err)
        log(f"[kernels] ra_layer {label}: max abs err {err:g}, differing "
            f"pixels {int((diff > 0).sum())} of {diff.numel()}")
        if not err <= RA_ATOL:
            raise AssertionError(f"ra_layer {label}: max abs err {err} "
                                 f"> {RA_ATOL}")

    def bound_ms(scal):
        # x read once, out written once, and x read again for each gated
        # image whose op needs a statistic (autocontrast, equalize, c != 0)
        sc = scal.cpu()
        stats = int(((sc[:, 11] > 0.5) & ((sc[:, 15] == 0) | (sc[:, 15] == 1)
                                          | (sc[:, 2] != 0))).sum())
        return (2 + stats / B) * nbytes / HBM_BYTES_PER_S * 1e3, stats

    for op in range(RA.N_OPS + 1):   # 15 ops + the identity op
        d = RA.draw_layer(B, g, 10.0, 0.5)
        apply = torch.rand(B, generator=g) < 0.75
        scal = scalars(torch.full((B,), op), apply, 0.5, d)
        check(f"op {op:2d} ({(RA.OP_NAMES + ('Identity',))[op]})", scal)
    for prob, flip_p in ((0.0, 0.0), (0.0, 1.0), (1.0, 0.5), (0.5, 0.5)):
        d = RA.draw_layer(B, g, 10.0, 0.5, prob=prob)
        scal = scalars(d["op"], d["apply"], flip_p, d)
        check(f"random ops, gate p={prob}, flip p={flip_p}", scal)
    ms = cuda_time_ms(lambda: RK.ra_layer(x, scal))
    plain_ms = cuda_time_ms(lambda: RK.ra_layer_plain(x, scal))
    reset_launch_counts()
    RK.ra_layer(x, scal)
    sync(dev)
    per_layer = launch_counts().get("ra_layer_kernels",
                                    "not counted by this wrapper")
    stats_bound, n_stats = bound_ms(scal)
    log(f"[kernels] ra_layer {shape} bf16, random ops: kernel {ms:.4f} ms,"
        f" plain {plain_ms:.3f} ms, bound {2 * nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
        f" ms (read once, write once; {stats_bound:.4f} with the second "
        f"read of the {n_stats} statistics images); kernel launches per "
        f"layer {per_layer} (the wrapper's count)")
    for label, op, prob in (("all gate off", None, 0.0),
                            ("all Invert", 2, 1.0), ("all Equalize", 1, 1.0),
                            ("all Sharpness", 10, 1.0),
                            ("all ShearX", 11, 1.0), ("all Rotate", 3, 1.0)):
        d = RA.draw_layer(B, g, 10.0, 0.5, prob=prob)
        cls = scalars(d["op"] if op is None else torch.full((B,), op),
                      d["apply"], 0.5, d)
        check(label, cls)
        t = cuda_time_ms(lambda: RK.ra_layer(x, cls))
        bound = bound_ms(cls)[0]
        log(f"[kernels] ra_layer class {label}: kernel {t:.4f} ms, bound "
            f"{bound:.4f} ms ({bound / t:.1%} of it)")
    results["ra_layer"] = {
        "source": "moma_tpu_torch/csrc/randaugment.cu",
        "replaces": "moma_tpu/ops/pallas_randaugment.py:214",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        # the image is read once and written once; no single PyTorch call
        # applies a per-image choice of 15 ops
        "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None}


def phase_augment_launches(dev="cuda", batch=64, image=512):
    """One augment of the main path (the histo stack of MAIN_ARGS:
    RandAugment rand-n2-m10-mstd0.5 with the flip in layer 1, then
    normalize) on a (64, 512, 512, 3) uint8 batch on the card.  The device
    operations it runs are counted from a torch.profiler trace's device
    events (CUDA kernels, copies, memsets), by name with their device time;
    one augment's time is CUDA events around the call, host work in."""
    import torch

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.core.profiling import (DEVICE_CATS, device_events,
                                               trace)
    from moma_tpu_torch.train.teacher import augment_fns

    dev = torch.device(dev)
    # the CLI's data and epoch flags are not the config's
    args, skip = [], 0
    for a in MAIN_ARGS:
        if skip or a == "--synthetic":
            skip = 0
        elif a in ("--print_freq", "--epochs"):
            skip = 1
        else:
            args.append(a)
    augment = augment_fns(parse_student_args(args))[0]
    images = torch.randint(0, 256, (batch, image, image, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(8)).to(dev)
    gen = torch.Generator().manual_seed(9)
    augment(images, gen)
    sync(dev)
    logdir = os.path.join(SAVE_ROOT, "augment_trace")
    with trace(logdir):
        augment(images, gen)
    events, _ = device_events(logdir)
    by_cat = {c: sum(1 for e in events if e["cat"] == c) for c in DEVICE_CATS}
    by_name = {}
    for e in events:
        n, us = by_name.get(e["name"][:80], (0, 0.0))
        by_name[e["name"][:80]] = (n + 1, us + float(e.get("dur", 0.0)))
    ms = cuda_time_ms(lambda: augment(images, gen), 5, spin=0)
    log(f"[augment] one augment of the main path ({batch}x{image}^2 uint8, "
        f"RandAugment n2 + normalize), counted from torch.profiler's device "
        f"events: {by_cat['kernel']} kernel launches, {by_cat['gpu_memcpy']} "
        f"copies, {by_cat['gpu_memset']} memsets; device time "
        f"{sum(us for _, us in by_name.values()) / 1e3:.3f} ms; one augment "
        f"{ms:.3f} ms (CUDA events, host work in)")
    log("[augment] by name (launches, device ms): " + "; ".join(
        f"{n} x{k} {us / 1e3:.4f}" for n, (k, us) in
        sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    return by_cat


def phase_flash_kernels(results, dev="cuda", shape=FLASH_SHAPE,
                        small=FLASH_SMALL):
    """flash_fwd / flash_dq / flash_dkv against their plain versions at the
    MoCoAtt path's shape in float32 and at one ragged shape in bf16; times,
    bounds and the library yardstick at the path's shape."""
    import torch
    import torch.nn.functional as F

    from moma_tpu_torch.ops import flash_attention as FA

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}

    def inputs(shp, dtype):
        H, N, d = shp
        qs = (torch.randn(shp, generator=gen, device=dev) * d ** -0.5)
        k, v, do = (torch.randn(shp, generator=gen, device=dev)
                    for _ in range(3))
        return [t.to(dtype) for t in (qs, k, v, do)]

    def check(name, shp, dtype, got, want):
        sync(dev)
        rtol = FLASH_RTOL[str(dtype)[6:]]
        for g, w in zip(got, want):
            err = float((g.float() - w.float()).abs().max())
            ref = float(w.float().abs().max())
            worst[name] = max(worst[name], err)
            if not (math.isfinite(err) and err <= rtol * ref):
                raise AssertionError(
                    f"{name} {shp} {dtype}: max abs err {err:.3e} exceeds "
                    f"{rtol} of max|ref| {ref:.3e}")
        return err

    for shp, dtype in ((small, torch.bfloat16), (shape, torch.float32)):
        qs, k, v, do = inputs(shp, dtype)
        o, m, l = FA._forward_stats(qs, k, v)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        cases = {
            "flash_fwd": (lambda: FA.flash_fwd(qs, k, v),
                          lambda: FA._forward_stats(qs, k, v)),
            "flash_dq": (lambda: (FA.flash_dq(qs, k, v, do, m, l, delta),),
                         lambda: (FA.flash_dq_plain(qs, k, v, do, m, l,
                                                    delta),)),
            "flash_dkv": (lambda: FA.flash_dkv(qs, k, v, do, m, l, delta),
                          lambda: FA.flash_dkv_plain(qs, k, v, do, m, l,
                                                     delta)),
        }
        for name, (kern, plain) in cases.items():
            err = check(name, shp, dtype, kern(), plain())
            log(f"[kernels] {name} {shp} {str(dtype)[6:]}: max abs err "
                f"{err:.2e}")
    # times at the path's shape (float32; the last inputs of the loop)
    H, N, d = shape
    flops = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}   # x H N^2 d
    n_in = {"flash_fwd": 3, "flash_dq": 4, "flash_dkv": 4}
    n_out = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 2}
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (qs, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        torch.autograd.grad(out, (q4, k4, v4), do[None])

    lib_err = float((sdpa_fwd()[0] - o).abs().max())
    if not lib_err <= 1e-3:
        raise AssertionError("scaled_dot_product_attention is not the same "
                             f"function: max abs diff {lib_err:.2e}")
    lib_fwd = cuda_time_ms(sdpa_fwd, FLASH_ITERS)
    lib_bwd = cuda_time_ms(sdpa_fwd_bwd, FLASH_ITERS) - lib_fwd
    # the library's backward does dq's and dk/dv's work in one call: each
    # kernel's share of it by operations (6 and 8 of the 14 H N^2 d flops)
    lib_share = {"flash_fwd": lib_fwd,
                 "flash_dq": lib_bwd * flops["flash_dq"] / 14,
                 "flash_dkv": lib_bwd * flops["flash_dkv"] / 14}
    log(f"[kernels] library yardstick scaled_dot_product_attention {shape} "
        f"f32: forward {lib_fwd:.3f} ms, backward (dq, dk and dv together; "
        f"forward+backward minus forward) {lib_bwd:.3f} ms; by operations "
        f"dq's 6/14 share {lib_share['flash_dq']:.3f} ms, dk/dv's 8/14 "
        f"{lib_share['flash_dkv']:.3f} ms")
    for name, (kern, plain) in cases.items():
        ms = cuda_time_ms(kern, FLASH_ITERS)
        plain_ms = cuda_time_ms(plain, FLASH_ITERS)
        op_ms = flops[name] * H * N * N * d / F32_ON_TF32_FLOPS * 1e3
        byte_ms = ((n_in[name] + n_out[name]) * H * N * d * 4
                   / HBM_BYTES_PER_S * 1e3)
        log(f"[kernels] {name} {shape} f32: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library share {lib_share[name]:.3f} ms "
            f"({ms / lib_share[name]:.2f}x), bound "
            f"{max(op_ms, byte_ms):.3f} ms "
            f"(operations at 165 TFLOP/s, float32 products as three TF32 "
            f"products at 495 TFLOP/s: {op_ms:.3f}; bytes {byte_ms:.4f}; "
            f"the same operations at 67 TFLOP/s float32 outside the tensor "
            f"cores {op_ms * F32_ON_TF32_FLOPS / F32_FLOPS:.3f}); "
            f"{flops[name] * H * N * N * d / ms * 1e-9:.1f} TFLOP/s")
        results[name] = {
            "source": "moma_tpu_torch/csrc/flash_attention.cu",
            "replaces": {"flash_fwd": "moma_tpu/ops/flash_attention.py:112",
                         "flash_dq": "moma_tpu/ops/flash_attention.py:203",
                         "flash_dkv": "moma_tpu/ops/flash_attention.py:240"
                         }[name],
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            # dq and dkv: the library's whole backward, which does the work
            # of both kernels in one call, and its share by operations
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
            "library_share_ms": lib_share[name]}


def fe_block_shapes(image=512):
    """(spec, input height) of each effiB0 MBConv block for a square input."""
    from moma_tpu_torch.ops import fused_effnet as FE

    h = -(-image // 2)
    out = []
    for spec in FE.block_specs("b0"):
        out.append((spec, h))
        h = -(-h // spec.stride)
    return out


def phase_fe_kernels(results, dev="cuda", image=512):
    """k1_expand_stats / k2_depthwise / k4_project against their plain
    versions at each of the 16 effiB0 block shapes of a 512^2 input: bf16 at
    batch 64 (the main path's) and f32 at batch 8, with affines from batch
    statistics (train mode) and from running statistics (eval mode).  Times
    in bf16 at batch 64: block FE_TIMED_BLOCK alone, and summed over the
    launches of one forward, each beside its bound (bytes, products and
    taps, with the silu's special-function work shown beside it; the sum
    over a forward's launches too), with the launch plan (grid.y, shared
    memory, blocks an SM, K1's channels a block, K2's tile) each took."""
    import torch

    from moma_tpu_torch.ops import fused_effnet as FE

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    names = ("k1_expand_stats", "k2_depthwise", "k4_project")
    worst = dict.fromkeys(names, 0.0)
    total = dict.fromkeys(names, 0.0)
    total_plain = dict.fromkeys(names, 0.0)
    total_bound = dict.fromkeys(names, 0.0)
    total_silu = dict.fromkeys(names, 0.0)
    timed = {}

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def bn(C):
        return {"scale": 1.0 + 0.1 * rn(C), "bias": 0.1 * rn(C)}

    def check_map(name, label, got, want, dtype):
        diff = (got.float() - want.float()).abs()
        err, ref = float(diff.max()), float(want.float().abs().max())
        worst[name] = max(worst[name], err)
        rtol = FE_RTOL[str(dtype)[6:]]
        if not (got.shape == want.shape and math.isfinite(err)
                and err <= rtol * ref):
            raise AssertionError(
                f"{name} {label}: max abs err {err:.3e} exceeds {rtol:.1e} "
                f"of max|ref| {ref:.3e}")
        return err / ref, float((diff > 0).float().mean())

    def check_sums(name, label, got, want, x, dtype):
        xf = x.float()
        rel = 0.0
        for g, w, bound in zip(got, want, (xf.abs().sum((0, 2, 3)),
                                           (xf * xf).sum((0, 2, 3)))):
            err = (g - w).abs()
            if name == "k1_expand_stats":
                worst[name] = max(worst[name], float(err.max()))
            rel = max(rel, float((err / (bound + 1e-6)).max()))
        rtol = FE_SUM_RTOL[str(dtype)[6:]]
        if not rel <= rtol:
            raise AssertionError(f"{name} {label}: sums off by {rel:.3e} of "
                                 f"sum|.|, more than {rtol:.1e}")
        return rel

    log("[kernels] fused_effnet: errors of maps as a share of max|ref|, of "
        "sums as a share of sum|.|")
    for dtype in (torch.bfloat16, torch.float32):
        N = FE_BATCH[str(dtype)[6:]]
        for i, (spec, H) in enumerate(fe_block_shapes(image)):
            C, E, k, st = (spec.in_filters, spec.in_filters * spec.expand,
                           spec.kernel, spec.stride)
            label = (f"block {i} y ({N},{C},{H},{H}) E={E} k{k} s{st} -> "
                     f"{spec.out_filters} {str(dtype)[6:]}")
            y = rn(N, C, H, H).to(dtype).contiguous(
                memory_format=torch.channels_last)
            w_dw = rn(E, k, k, scale=1.0 / k)
            w_proj = rn(spec.out_filters, E, scale=E ** -0.5).to(dtype)
            se = torch.sigmoid(rn(N, E))
            running = {"mean": 0.05 * rn(E), "var": 0.5 + 0.5 * torch.rand(
                E, generator=gen, device=dev)}
            w_exp = None
            rel = {}
            share = 0.0
            if spec.expand != 1:
                w_exp = rn(E, C, scale=C ** -0.5).to(dtype)
                s1 = FE.k1_expand_stats(y, w_exp)
                sync(dev)
                rel["k1 sums"] = check_sums(
                    names[0], label, s1, FE.k1_expand_stats_plain(y, w_exp),
                    FE._pw(y, w_exp), dtype)
            for mode in ("train", "eval"):
                # without expand conv K2 takes no affine: both modes alike
                ab1 = None
                if w_exp is not None:
                    mv = (FE._mv(*s1, N * H * H) if mode == "train"
                          else (running["mean"], running["var"]))
                    ab1 = FE._affine(bn(E), *mv)
                dw, s2, q2 = FE.k2_depthwise(y, w_exp, ab1, w_dw, st)
                dw_p, s2_p, q2_p = FE.k2_depthwise_plain(y, w_exp, ab1, w_dw,
                                                         st)
                mv = (FE._mv(s2_p, q2_p, dw_p.numel() // E) if mode == "train"
                      else (running["mean"], running["var"]))
                ab2 = FE._affine(bn(E), *mv)
                tmp, s3, q3 = FE.k4_project(dw_p, ab2, se, w_proj)
                tmp_p, s3_p, q3_p = FE.k4_project_plain(dw_p, ab2, se, w_proj)
                sync(dev)
                for key, name, got, want, sums in (
                        ("dwout", names[1], dw, dw_p, ((s2, q2), (s2_p, q2_p))),
                        ("tmp", names[2], tmp, tmp_p, ((s3, q3), (s3_p, q3_p)))):
                    r, sh = check_map(name, f"{label} {mode}", got, want,
                                      dtype)
                    rel[key] = max(rel.get(key, 0.0), r)
                    share = max(share, sh)
                    key = f"{name[:2]} sums"
                    rel[key] = max(rel.get(key, 0.0), check_sums(
                        name, f"{label} {mode}", *sums, want, dtype))
                del dw, tmp, tmp_p
            line = (f"[kernels] fused_effnet {label}: "
                    + ", ".join(f"{k_} {v:.1e}" for k_, v in rel.items())
                    + f"; differing elements {share:.1e}")
            if dtype == torch.bfloat16:
                cases = {names[1]: (
                    lambda: FE.k2_depthwise(y, w_exp, ab1, w_dw, st),
                    lambda: FE.k2_depthwise_plain(y, w_exp, ab1, w_dw, st)),
                    names[2]: (
                    lambda: FE.k4_project(dw_p, ab2, se, w_proj),
                    lambda: FE.k4_project_plain(dw_p, ab2, se, w_proj))}
                if w_exp is not None:
                    cases[names[0]] = (
                        lambda: FE.k1_expand_stats(y, w_exp),
                        lambda: FE.k1_expand_stats_plain(y, w_exp))
                ms = {}
                for name, (kern, plain) in cases.items():
                    ms[name] = (cuda_time_ms(kern, 10),
                                cuda_time_ms(plain, FE_PLAIN_ITERS))
                    total[name] += ms[name][0]
                    total_plain[name] += ms[name][1]
                line += "; kernel/plain ms " + ", ".join(
                    f"{n_[:2]} {a:.3f}/{b:.3f}" for n_, (a, b) in ms.items())
                # least time: each input read once and each output written
                # once at 3.35 TB/s, against the busiest unit's operations:
                # the 1x1 products (2*E*C flops per input pixel in K1 and
                # K2, 2*Cout*E per pixel in K4) take bf16 operands and
                # accumulate in float32, the tensor cores' 989 TFLOP/s; the
                # depthwise taps (2*k*k*E per output pixel in K2) are
                # float32 weights on float32 sums, 67 TFLOP/s.  Shown
                # beside the bound, not part of it: each activated
                # element's silu (E per input pixel in K2, E per output
                # pixel in K4) as an exponential and a reciprocal on the
                # special-function units
                px_in, px_out = N * H * H, dw_p.numel() // E
                Co, b = spec.out_filters, y.element_size()
                work = {
                    names[1]: (b * (px_in * C + E * C + px_out * E)
                               + 4 * E * (2 + k * k) + 8 * E,
                               2 * E * C * px_in if w_exp is not None else 0,
                               2 * k * k * E * px_out,
                               E * px_in if w_exp is not None else 0),
                    names[2]: (b * (px_out * (E + Co) + Co * E)
                               + 4 * (2 * E + N * E) + 8 * Co,
                               2 * Co * E * px_out, 0, E * px_out)}
                if w_exp is not None:
                    work[names[0]] = (b * (px_in * C + E * C) + 8 * E,
                                      2 * E * C * px_in, 0, 0)
                for name, (nbytes, mm, f32, silu) in work.items():
                    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                             "products": mm / BF16_TENSOR_FLOPS * 1e3,
                             "taps": f32 / F32_FLOPS * 1e3,
                             "silu": silu * SFU_PER_SILU / SFU_OPS_PER_S
                             * 1e3}
                    op_ms = max(parts["products"], parts["taps"])
                    bound = max(parts["bytes"], op_ms)
                    total_bound[name] += bound
                    total_silu[name] += parts["silu"]
                    line += (f"; {name[:2]} bound {bound:.4f} (" + ", ".join(
                        f"{k_} {parts[k_]:.4f}" for k_ in ("bytes",
                                                           "products", "taps"))
                        + f"; silu {parts['silu']:.4f} not in it)")
                    if i == FE_TIMED_BLOCK:
                        timed[name] = {
                            "ms": ms[name][0], "plain_ms": ms[name][1],
                            "bound_ms": bound,
                            "bound_by": ("operations"
                                         if op_ms >= parts["bytes"]
                                         else "bytes"), **parts}
                # the launch plans K1, K2 and K4 took: grid.y, dynamic
                # shared memory a block, blocks an SM holds (then K1's
                # channels a block, K2's output tile)
                Ho = dw_p.shape[2]
                plans = {
                    "k2": FE.launch_plan(names[1], 1, N, C, E, k, st, Ho, Ho,
                                         int(w_exp is not None)),
                    "k4": FE.launch_plan(names[2], 1, px_out, Ho * Ho,
                                         spec.out_filters)}
                if w_exp is not None:
                    plans["k1"] = FE.launch_plan(names[0], 1, px_in, C, E)
                line += ("; plans (grid.y, smem, per SM, K1's channels a "
                         "block, K2's tile rows, cols) ") + ", ".join(
                    f"{k_} {v}" for k_, v in plans.items())
            log(line)
            del y, dw_p
    replaces = dict(zip(names, (207, 229, 256)))
    for name in names:
        t = timed[name]
        parts = {k_: t.pop(k_) for k_ in ("bytes", "products", "taps",
                                           "silu")}
        log(f"[kernels] {name} bf16 batch {FE_BATCH['bfloat16']}: block "
            f"{FE_TIMED_BLOCK} kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} (" + ", ".join(
                f"{k_} {v:.4f}" for k_, v in parts.items())
            + "; bytes at 3.35 TB/s, products at the 989 TFLOP/s bf16 "
            "tensor rate, taps at 67 TFLOP/s f32; not in the bound, silu at "
            "2 operations of the special-function units' 4.18 T/s)")
        loss = total[name] - total_bound[name]
        log(f"[kernels] {name} summed over one forward's launches: kernel "
            f"{total[name]:.3f} ms, plain {total_plain[name]:.3f} ms, bound "
            f"{total_bound[name]:.4f} ms (silu on the special-function "
            f"units {total_silu[name]:.4f} ms, not in it); loss "
            f"{loss:.3f} ms a forward, "
            f"{2 * loss:.3f} ms a step (two train-mode teacher forwards)")
        results[name] = {
            "source": "moma_tpu_torch/csrc/fused_effnet.cu",
            "replaces": f"moma_tpu/ops/fused_effnet_pallas.py:{replaces[name]}",
            "max_abs_err": worst[name],
            # no single PyTorch call computes a conv together with its
            # BatchNorm statistics without writing the conv's output
            "library_ms": None, **t}


def phase_fe_forward(dev="cuda", f32_sizes=((4, 64), (2, 512)),
                     main_size=(64, 512)):
    """fused_forward against the EfficientNet module's forward on the card,
    same weights.  float32 with TF32 off: pooled, logits and the 49 (mean,
    var) pairs (the module's, read from its running statistics after a
    forward with momentum 0) within FE_FWD_RTOL; bf16 at the main path's
    batch 64, 512^2: the gap, bounded at FE_FWD_BF16_RTOL, and the time of
    both forwards in train mode."""
    import copy

    import torch

    from moma_tpu_torch.models.efficientnet import EfficientNet
    from moma_tpu_torch.ops import fused_effnet as FE

    dev = torch.device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(4)

    def build(dtype):
        m = EfficientNet("b0", num_classes=4, dtype=dtype, generator=g)
        for mod in m.modules():
            if type(mod).__name__ == "FusedBatchNorm":
                mod.running_mean.copy_(0.05 * torch.randn(
                    mod.running_mean.shape, generator=g))
                mod.running_var.copy_(0.5 + 0.5 * torch.rand(
                    mod.running_var.shape, generator=g))
        return m.to(dev, memory_format=torch.channels_last)

    def rel(got, want, floor=1e-6):
        return float((got - want).abs().max()) / (float(want.abs().max())
                                                  + floor)

    model = build(None)
    for B, S in f32_sizes:
        x = torch.randn(B, S, S, 3, generator=g).to(dev)
        for train in (False, True):
            ref = copy.deepcopy(model).train(train)
            bns = [mod for mod in ref.modules()
                   if type(mod).__name__ == "FusedBatchNorm"]
            for mod in bns:
                mod.momentum = 0.0    # running statistics <- batch statistics
            with torch.no_grad():
                feats, logits = ref(x)
            params, specs = FE.extract_params(model)
            pooled, lg, coll = FE.fused_forward(params, specs, x, train,
                                                torch.float32)
            sync(dev)
            errs = {"pooled": rel(pooled, feats[-1]), "logits": rel(lg, logits)}
            if train:
                order = FE.bn_order(FE.extract_params(ref)[0], specs)
                if not len(coll) == len(order) == len(bns) == 49:
                    raise AssertionError(f"{len(coll)} statistics pairs")
                errs["mean"] = max(rel(m_, bn_["mean"], 1e-2)
                                   for (m_, _), bn_ in zip(coll, order))
                errs["var"] = max(rel(v_, bn_["var"], 1e-2)
                                  for (_, v_), bn_ in zip(coll, order))
            elif coll:
                raise AssertionError("eval mode collected statistics")
            log(f"[forward] fused vs module f32 batch {B} at {S}^2 "
                f"{'train' if train else 'eval'}: " + ", ".join(
                    f"{k} {v:.2e}" for k, v in errs.items())
                + " of max|ref|")
            bad = {k: v for k, v in errs.items() if not v <= FE_FWD_RTOL}
            if bad:
                raise AssertionError(f"fused forward off by {bad}")
    torch.backends.cudnn.allow_tf32 = True

    model = build(torch.bfloat16).train(True)
    B, S = main_size
    x = torch.randint(0, 256, (B, S, S, 3), generator=g).to(
        dev, torch.bfloat16)
    x = (x - 128.0) / 64.0
    params, specs = FE.extract_params(model)
    with torch.no_grad():
        feats, _ = model(x)
        pooled, _, coll = FE.fused_forward(params, specs, x, True,
                                           torch.bfloat16)
        gap = rel(pooled, feats[-1].float())
        if not (len(coll) == 49 and gap <= FE_FWD_BF16_RTOL):
            raise AssertionError(f"bf16 fused forward: gap {gap:.3f} of "
                                 f"max|pooled|, {len(coll)} pairs")
        fused_ms = cuda_time_ms(lambda: FE.fused_forward(
            params, specs, x, True, torch.bfloat16), 10)
        module_ms = cuda_time_ms(lambda: model(x), 10)
        fused_eval_ms = cuda_time_ms(lambda: FE.fused_forward(
            params, specs, x, False, torch.bfloat16), 10)
        model.train(False)
        module_eval_ms = cuda_time_ms(lambda: model(x), 10)
    log(f"[forward] bf16 batch {B} at {S}^2: fused vs module pooled gap "
        f"{gap:.3f} of max|ref|; train mode fused {fused_ms:.2f} ms, module "
        f"{module_ms:.2f} ms; eval mode fused {fused_eval_ms:.2f} ms, module "
        f"{module_eval_ms:.2f} ms")


def phase_step_parity(mem="MoCo", attn="self", nce_k="64", extra=()):
    """One MoMA step (augmentation included) at 64^2, batch 4, f32: the
    CPU run uses every kernel's plain version, the CUDA run the kernels;
    same weights, images and draws.  TF32 off, so the gap is f32
    summation order only."""
    import numpy as np
    import torch

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.moma import build_state, make_moma_train_step
    from moma_tpu_torch.train.teacher import augment_fns

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_student_args([
        "--distill", "moma", "--dataset", "prostate_hv", "--model_s",
        "effiB0", "--model_t", "effiB0", "--image_size", "64",
        "--batch_size", "4", "--nce_k", nce_k, "--feat_dim", "32", "--head",
        "mlp", "--mem", mem, "--attn", attn, "-b", "1", "--fp32", "--epochs",
        "1", *extra])
    rs = np.random.RandomState(0)
    batch = {"image": rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "label": rs.randint(0, 4, (4,)).astype(np.int32)}
    out = {}
    for dev in ("cpu", "cuda"):
        device = torch.device(dev)
        state = build_state(cfg, device, steps_per_epoch=4, seed=0)
        step = make_moma_train_step(cfg, augment_fns(cfg)[0],
                                    kl_train_bn_override=True,
                                    cross_arch=state.ema is not None)
        state, m = step(state, to_device(batch, device),
                        torch.Generator().manual_seed(5))
        out[dev] = (m, state)
    torch.backends.cudnn.allow_tf32 = True
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        a, b = float(mc[k]), float(mg[k])
        if not abs(a - b) <= 1e-3 * abs(a) + 1e-5:
            raise AssertionError(f"step parity {k}: cpu {a} vs cuda {b}")
    # the student, and in cross-arch mode the EMA copy: per-tensor
    # relative error; tensors that are zero up to float noise (a BN bias
    # feeding the next train-mode BN has a zero gradient) are held to 1e-3
    # of the largest parameter instead of their own size
    worst = 0.0
    for net in ("student", "ema"):
        if getattr(sc, net) is None:
            continue
        pairs = [(pc.detach(), pg.detach().cpu()) for pc, pg in
                 zip(getattr(sc, net).parameters(),
                     getattr(sg, net).parameters())]
        floor = 1e-3 * max(float(pc.abs().max()) for pc, _ in pairs)
        worst = max([worst] + [float((pc - pg).abs().max())
                               / max(float(pc.abs().max()), floor)
                               for pc, pg in pairs])
    qerr = float((sc.queue.memory["memory"]
                  - sg.queue.memory["memory"].cpu()).abs().max())
    if not (worst <= 1e-3 and qerr <= 1e-3):
        raise AssertionError(f"step parity: student (and EMA copy) params "
                             f"rel {worst:.2e}, queue {qerr:.2e}")
    log(f"[parity] {mem}/{attn} K={nce_k} {' '.join(extra)} 64^2 f32 step cpu "
        f"vs cuda: loss "
        f"{float(mc['loss']):.6f} vs {float(mg['loss']):.6f}; loss_kd "
        f"{float(mc['loss_kd']):.6f} vs {float(mg['loss_kd']):.6f}; student "
        f"{'and EMA copy ' if sc.ema is not None else ''}params max rel "
        f"diff {worst:.2e}; queue max diff {qerr:.2e}")


def expected_launches(state, n, flash_per_step=0, fused=False, ra=2,
                      accum=1):
    """The kernel launches of an epoch of n steps of the 'exact' schedule
    on the state's model (and the number of its student's BatchNorms);
    `ra` RandAugment layers a step (0 on the CIFAR augment).  `accum`: the
    --grad_accum microbatches, each its own augment and its own student,
    KL and key forwards."""
    n_bn = sum(1 for m in state.student.modules()
               if type(m).__name__ == "FusedBatchNorm")
    # first batch: eval-BN KL forward ('exact'), so student + key forwards;
    # later batches add the train-BN KL forward: 2n - 1 train-mode teacher
    # forwards and 2n teacher forwards in all.  Cross-arch: the student and
    # the EMA copy's key forward a step, the fixed teacher in eval mode
    teacher_train = n if state.ema is not None else 2 * n - 1
    want = {"channel_sums": accum * (n_bn * n + n_bn * teacher_train),
            "grad_channel_sums": accum * n_bn * n,
            "ra_layer": accum * ra * n, "ra_layer_kernels": 2 * accum * ra * n,
            "flash_fwd": flash_per_step * n,
            "flash_dq": flash_per_step * n, "flash_dkv": flash_per_step * n,
            "k1_expand_stats": 0, "k2_depthwise": 0, "k4_project": 0}
    if fused:
        # the fused forward takes only its stem and head statistics through
        # channel_sums; K1 runs in train mode, for blocks with expand conv
        blocks = state.teacher.blocks
        n_exp = sum(1 for blk in blocks if blk.has_expand)
        want.update({"channel_sums": n_bn * n + 2 * (2 * n - 1),
                     "k1_expand_stats": n_exp * (2 * n - 1),
                     "k2_depthwise": len(blocks) * 2 * n,
                     "k4_project": len(blocks) * 2 * n})
    return want, n_bn


# the runs of phase_main_path by label: state, result, steady step (s),
# peak memory (bytes), launch counts, step losses (phase_packed compares
# against "main")
MAIN_RUNS = {}


def phase_main_path(args=MAIN_ARGS, label="main", flash_per_step=0,
                    fused=False, steps=4, remat=False, accum=1):
    """Drive the CLI with `args`; `flash_per_step` launches of each
    flash-attention kernel are expected per step (0 on the MoCo path, whose
    attentions see 64 tokens and stay dense); `fused`: both teacher forwards
    run the fused EfficientNet forward; `remat`: the student's train-mode
    BatchNorms run once more a step, in the backward's replay; `accum`:
    args hold --grad_accum `accum`."""
    import torch

    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, result = train_student.main(list(args)
                                       + ["--save_dir", SAVE_ROOT])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    tr = result["train"]
    n = tr["steps"]
    for k in ("loss", "acc1"):
        if not math.isfinite(tr[k]):
            raise AssertionError(f"main path: train {k} {tr[k]} not finite")
    for k in ("loss", "acc", "f1"):
        if not math.isfinite(result["val"][k]):
            raise AssertionError(f"main path: val {k} not finite")
    if n != steps:
        raise AssertionError(f"main path ran {n} steps, expected {steps}")
    if state.queue.ptr != (64 * n) % 16384:
        raise AssertionError(f"queue_ptr {state.queue.ptr} != {64 * n}")
    want, n_bn = expected_launches(state, n, flash_per_step, fused,
                                   accum=accum)
    if remat:
        want["channel_sums"] += n_bn * n
    log(f"[{label}] launch counts {counts} (expected {want}, {n_bn} BNs)")
    for k, v in want.items():
        if counts.get(k, 0) != v:
            raise AssertionError(f"launch count {k}: {counts.get(k, 0)} "
                                 f"!= {v}")
    steady = statistics.median(tr["batch_times"][1:])
    log(f"[{label}] {n} steps + eval in {wall:.1f} s; train loss {tr['loss']:.4f}"
        f", val acc {result['val']['acc']:.2f}; queue_ptr {state.queue.ptr}")
    log(f"[{label}] step times (s) {[round(t, 4) for t in tr['batch_times']]}; "
        f"steady step {steady * 1e3:.1f} ms = {64 / steady:.1f} img/s; "
        f"peak memory {peak / 2 ** 30:.2f} GiB")
    # this run's step losses: runs of one run name share its scalars.jsonl
    MAIN_RUNS[label] = {"state": state, "result": result, "steady": steady,
                        "peak": peak, "counts": counts,
                        "losses": _step_losses(result["run_dir"])[-n:]}
    return counts

# phase_packed: a seeded JPEG tree in imagefolder layout (train/<class>/,
# val/<class>/), every source 600^2 so the pack's resize runs
PACKED_SPLITS = (384, 64)
PACKED_SRC = 600
PACKED_CLASSES = 4
PACKED_PIL_ROWS = 16       # rows held against PIL's decode + resize
CARD = ""                  # the card's name and power limit (main() sets it)
RUNNING_RTOL = 1e-3        # --remat's BN running statistics, of scale


def _write_jpeg_tree(root, seed=0):
    """PACKED_SPLITS JPEGs (quality 90) of PACKED_SRC^2: one of 8 seeded
    smooth patterns, rolled, plus seeded noise, so no two are alike."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:PACKED_SRC, 0:PACKED_SRC].astype(np.float32)
    bases = []
    for _ in range(8):
        f, ph = rs.uniform(6, 40, 3), rs.uniform(0, 6.3, 3)
        bases.append(np.stack([128 + 90 * np.sin(x / f[c] + ph[c])
                               * np.cos(y / f[2 - c]) for c in range(3)], -1))
    jobs = [(split, i) for split, n in zip(("train", "val"), PACKED_SPLITS)
            for i in range(n)]

    def write(job):
        split, i = job
        r = np.random.RandomState(seed * 1000 + i + (split == "val") * 500)
        img = np.roll(bases[i % 8], r.randint(PACKED_SRC, size=2), (0, 1))
        img = np.clip(img + r.randint(-12, 13, img.shape), 0, 255)
        d = os.path.join(root, split, f"class{i % PACKED_CLASSES}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(d, f"{i:04d}.jpg"), quality=90)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, jobs))


def _pack(root, size):
    """(train, val) packed by the port's PackedCache at `size`, as the
    CLI opens them; logs the route, the decode rate and the checks."""
    import numpy as np

    from moma_tpu_torch.data.histo import PackedCache, _decode_resize
    from moma_tpu_torch.data.manifests import PREPARERS

    train_pairs, val_pairs, _ = PREPARERS["imagefolder"](root)
    cache = PackedCache(os.path.join(root, "_moma_pack"))
    out, builds = [], []
    for pairs in (train_pairs, val_pairs):
        out.append(cache.build_or_open(pairs, size))
        builds.append(cache.last_build)
    n = sum(b["n"] for b in builds)
    rate = n / sum(b["seconds"] for b in builds)
    route = builds[0]["route"]
    # a row the native decoder could not read and PIL did not fill would
    # be zero; on the native route PIL takes no row of a JPEG tree
    empty = sum(int((ds.images.reshape(len(ds), -1).max(1) == 0).sum())
                for ds in out)
    pil_rows = sum(b["pil_rows"] for b in builds)
    if empty or (route == "native" and pil_rows):
        raise AssertionError(f"pack {size}: {empty} empty rows, {pil_rows} "
                             "rows through PIL")
    rows = np.linspace(0, len(train_pairs) - 1, PACKED_PIL_ROWS).astype(int)
    gap = max(int(np.abs(out[0].images[i].astype(np.int16) - _decode_resize(
        train_pairs[i][0], size).astype(np.int16)).max()) for i in rows)
    if gap > 1:
        raise AssertionError(f"pack {size}: {gap} grey levels from PIL")
    log(f"[packed] ({CARD}) pack {size}^2 of {n} JPEGs of {PACKED_SRC}^2: "
        f"route {route}, {rate:.1f} img/s ({builds[0]['key']}, "
        f"{builds[1]['key']}); rows through PIL {pil_rows}, empty rows 0; "
        f"largest difference from PIL over {PACKED_PIL_ROWS} rows {gap} "
        "grey level(s)")
    return out


def _host_loader_times(ds, size, batch=64):
    """Host ms a batch: numpy's fancy-index gather on the memmap against
    the native prefetcher's wait a batch (its Loader iterated with no step
    between batches: assembly throughput, the worst case), on the CPU route
    and on the pinned CUDA route; then the H2D copy of one batch from
    pageable and from pinned memory (CUDA events)."""
    import numpy as np
    import torch

    from moma_tpu_torch.data.pipeline import Loader

    np.asarray(ds.images).sum()          # the pack in the page cache
    n = len(ds) // batch
    order = np.random.RandomState(0).permutation(len(ds))
    gather = []
    for i in range(n):
        t = time.perf_counter()
        ds.images[order[i * batch:(i + 1) * batch]]
        gather.append(time.perf_counter() - t)
    waits = {}
    for route, device in (("cpu", None), ("pinned", torch.device("cuda"))):
        ld = Loader(ds, batch, True, seed=0, num_workers=8, device=device)
        for epoch in range(2):           # the first builds ring and threads
            ld.set_epoch(epoch)
            w, t = [], time.perf_counter()
            for _ in ld:
                w.append(time.perf_counter() - t)
                t = time.perf_counter()
        torch.cuda.synchronize()
        waits[route] = statistics.median(w)
    host = torch.from_numpy(np.ascontiguousarray(ds.images[:batch]))
    pinned = host.pin_memory()
    h2d = {"pageable": cuda_time_ms(lambda: host.to("cuda"), 10, spin=0),
           "pinned": cuda_time_ms(
               lambda: pinned.to("cuda", non_blocking=True), 10, spin=0)}
    mb = host.numel() / 1e6
    log(f"[packed] ({CARD}) host loader at {size}^2, batch {batch} "
        f"({mb:.1f} MB): numpy gather {1e3 * statistics.median(gather):.2f} "
        f"ms a batch; native prefetcher's wait {1e3 * waits['cpu']:.2f} ms "
        f"(CPU route), {1e3 * waits['pinned']:.2f} ms (pinned CUDA route, "
        f"copy enqueued); H2D copy pageable {h2d['pageable']:.2f} ms "
        f"({mb / h2d['pageable']:.1f} GB/s), pinned {h2d['pinned']:.2f} ms "
        f"({mb / h2d['pinned']:.1f} GB/s)")


def _running_stats_gap(got, want):
    """Largest |got - want| of the BN running statistics over each
    tensor's scale, floored at 1e-3 of the largest."""
    pairs = [(a, b) for (n, a), (_, b) in zip(got.named_buffers(),
                                               want.named_buffers())
             if n.endswith(("running_mean", "running_var"))]
    floor = 1e-3 * max(float(b.abs().max()) for _, b in pairs)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), floor)
               for a, b in pairs)


def phase_effnet_options(batch=64, image=512):
    """One vanilla student step of effiB0 at `image`^2, batch `batch`, bf16,
    plain, with --remat's whole-forward checkpoint and with
    EfficientNet(block_remat=True): steady step time and peak memory; then
    the stem alone at (batch, 3, image, image) bf16 with stem_s2d 0 / 2 /
    4: device time and the largest difference from stem_s2d=0.  A
    measurement only: the default stays 0."""
    import torch

    from moma_tpu_torch.models.common import conv2d_same
    from moma_tpu_torch.models.efficientnet import (EfficientNet,
                                                    stem_s2d_conv)
    from moma_tpu_torch.train.state import TrainState, make_sgd
    from moma_tpu_torch.train.steps import make_vanilla_train_step

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(batch, image, image, 3, device="cuda", generator=g)
    batch_ = {"image": x, "label": torch.arange(batch, device="cuda") % 4}
    losses = {}
    for name, kw, remat in (("plain", {}, False), ("remat", {}, True),
                            ("block_remat", {"block_remat": True}, False)):
        torch.cuda.empty_cache()
        m = EfficientNet("b0", num_classes=4, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **kw)
        m = m.to("cuda", memory_format=torch.channels_last)
        state = TrainState(model=m, optimizer=make_sgd(m.parameters(), 0.9,
                                                       5e-4),
                           schedule=lambda s: 0.05)
        step = make_vanilla_train_step(None, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(4):
            t = time.perf_counter()
            state, met = step(state, batch_, None)
            loss = float(met["loss"])   # a sync
            times.append(time.perf_counter() - t)
            if i == 0:
                losses[name] = loss
        peak = torch.cuda.max_memory_allocated()
        log(f"[options] ({CARD}) effiB0 {image}^2 batch {batch} bf16 student "
            f"step, {name}: steady {1e3 * statistics.median(times[1:]):.1f} "
            f"ms, peak {peak / 2 ** 30:.2f} GiB, first loss "
            f"{losses[name]:.6f}")
        del state, m, step
    for name in ("remat", "block_remat"):
        if abs(losses[name] - losses["plain"]) > STEP_LOSS_RTOL * abs(
                losses["plain"]):
            raise AssertionError(f"{name}: loss {losses[name]} against "
                                 f"{losses['plain']}")
    w = torch.randn(32, 3, 3, 3, device="cuda",
                    generator=g).to(torch.bfloat16)
    xs = x.to(torch.bfloat16).permute(0, 3, 1, 2)   # channels_last NCHW
    ref = conv2d_same(xs, w, None, 2)
    base = cuda_time_ms(lambda: conv2d_same(xs, w, None, 2))
    parts = [f"s2d=0 {base:.3f} ms"]
    for f in (2, 4):
        y = stem_s2d_conv(xs, w, f)
        gap = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if gap > 2 ** -7 * scale * 2:
            raise AssertionError(f"stem_s2d={f}: {gap} from s2d=0")
        ms = cuda_time_ms(lambda: stem_s2d_conv(xs, w, f))
        parts.append(f"s2d={f} {ms:.3f} ms (max |diff| {gap:.4g} of "
                     f"max |y| {scale:.4g})")
    log(f"[options] ({CARD}) stem alone at ({batch}, 3, {image}, {image}) "
        "bf16: " + "; ".join(parts))


def phase_packed():
    """The main path trained from a packed on-disk dataset: a seeded JPEG
    tree packed by the port, the host loader's times at 512^2 and 224^2,
    the MoCo main path from the pack through the CLI (--dataset
    imagefolder --num_workers 8: 6 steps, launch counts, steady step and
    data time a step against phase_main_path's --synthetic run, every batch
    through the pinned ring), then --remat on the --synthetic main path
    (4 steps: 196 channel_sums a step, step losses and the student's
    running statistics against the plain run, step time and peak memory),
    then phase_effnet_options."""
    import torch

    from moma_tpu_torch.data import pipeline

    root = os.path.join(SAVE_ROOT, "jpeg_tree")
    t0 = time.perf_counter()
    _write_jpeg_tree(root)
    log(f"[packed] wrote {sum(PACKED_SPLITS)} JPEGs of {PACKED_SRC}^2 in "
        f"{time.perf_counter() - t0:.1f} s")
    train, _ = _pack(root, 512)
    _host_loader_times(train, 512)
    _host_loader_times(_pack(root, 224)[0], 224)

    copies = [0]
    to_device = pipeline.PinnedRing.to_device

    def counted(self, j):
        copies[0] += 1
        return to_device(self, j)

    args = [a for a in with_flags(MAIN_ARGS, dataset="imagefolder")
            if a != "--synthetic"] + [
        "--data_dir", root, "--n_cls", str(PACKED_CLASSES),
        "--num_workers", "8"]
    steps = PACKED_SPLITS[0] // 64
    pipeline.PinnedRing.to_device = counted
    try:
        counts = phase_main_path(args, "packed", steps=steps)
    finally:
        pipeline.PinnedRing.to_device = to_device
    if copies[0] != steps:
        raise AssertionError(f"{copies[0]} batches through the pinned ring, "
                             f"expected {steps}")
    main, packed = MAIN_RUNS["main"], MAIN_RUNS["packed"]
    data = {k: statistics.median(r["result"]["train"]["data_times"][1:])
            for k, r in (("main", main), ("packed", packed))}
    log(f"[packed] ({CARD}) steady step {packed['steady'] * 1e3:.1f} ms from "
        f"the pack against {main['steady'] * 1e3:.1f} ms --synthetic "
        f"({100 * (packed['steady'] / main['steady'] - 1):+.1f}%); data "
        f"time a step {data['packed'] * 1e3:.2f} ms against "
        f"{data['main'] * 1e3:.2f} ms; peak {packed['peak'] / 2 ** 30:.2f} "
        f"GiB; {copies[0]} batches through the pinned ring")

    phase_main_path(MAIN_ARGS + ["--remat", "--trial", "remat"], "remat",
                    remat=True)
    remat = MAIN_RUNS["remat"]
    worst = _check_losses(remat["losses"], main["losses"], "remat")
    gap = _running_stats_gap(remat["state"].student, main["state"].student)
    if not gap <= RUNNING_RTOL:
        raise AssertionError(f"remat: running statistics {gap:.2e} of scale "
                             "from the plain run's")
    n_bn = sum(1 for m in main["state"].student.modules()
               if type(m).__name__ == "FusedBatchNorm")
    per_step = {k: (remat["counts"].get(k, 0) - main["counts"].get(k, 0))
                / 4 for k in ("channel_sums", "grad_channel_sums")}
    log(f"[remat] ({CARD}) steady step {remat['steady'] * 1e3:.1f} ms against "
        f"{main['steady'] * 1e3:.1f} ms "
        f"({1e3 * (remat['steady'] - main['steady']):+.1f} ms); peak "
        f"{remat['peak'] / 2 ** 30:.2f} GiB against "
        f"{main['peak'] / 2 ** 30:.2f} GiB; launches a step beyond the "
        f"plain run's: channel_sums +{per_step['channel_sums']:g} "
        f"({n_bn} student BNs replayed), grad_channel_sums "
        f"+{per_step['grad_channel_sums']:g}; step losses within "
        f"{worst:.2e}; student running statistics within {gap:.2e} of scale")
    if per_step != {"channel_sums": n_bn, "grad_channel_sums": 0}:
        raise AssertionError(f"remat: launches a step {per_step}")
    MAIN_RUNS.clear()
    torch.cuda.empty_cache()
    phase_effnet_options()
    return counts


# phase_persistence: effiB0 at 512^2, batch 64, K 16384, bf16, the MoCo
# main path's flags, synthetic sets cut to 2 training batches an epoch (1
# for part g)
PERSIST_SETS = (128, 64, 64)
STEP_LOSS_RTOL = 1e-3     # PERF.md section 2: step losses
# a resumed run against the straight one: the state restored bit for bit
# (part b), so they differ only where the card's own sums are not
# reproducible (cuDNN's backward algorithms by default); in bf16 such a
# difference can flip an activation's rounding, one bf16 ulp (2^-8 of it).
# Held per tensor to 1e-2 of its largest magnitude (floored at 1e-3 of its
# group's), 2.5 bf16 ulps at that scale, over 4 steps
STATE_RTOL = 1e-2


def _args(base, epochs, *extra):
    out = list(base)
    out[out.index("--epochs") + 1] = str(epochs)
    return out + ["--save_dir", SAVE_ROOT, *extra]


def _tensors(tree, path=""):
    """(path, tensor) over a nested dict / list of tensors and numbers."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _state_gap(got, want):
    """max over tensors of max|got - want| / max(max|want|, group floor),
    the groups being student, teacher, heads, queue, optimizer and, in
    cross-arch runs, the EMA copy; in distillation runs the aux modules
    and the CRD memory ('extra')."""
    worst, where = 0.0, ""
    if set(got) != set(want):
        raise AssertionError(f"state groups {sorted(got)} != {sorted(want)}")
    for group in [g for g in ("student", "teacher", "heads", "queue",
                              "optimizer", "ema", "aux", "extra")
                  if g in want]:
        pairs = dict(_tensors(want[group]))
        floor = 1e-3 * max((float(t.float().abs().max()) for t in
                            pairs.values() if t.numel()), default=0.0)
        got_t = dict(_tensors(got[group]))
        if set(got_t) != set(pairs):
            raise AssertionError(f"state {group}: tensors differ")
        for k, w in pairs.items():
            if not w.numel() or not w.is_floating_point():
                if not torch_equal(got_t[k], w):
                    raise AssertionError(f"state {group}{k} differs")
                continue
            d = float((got_t[k].float() - w.float()).abs().max())
            rel = d / max(float(w.float().abs().max()), floor, 1e-30)
            if rel > worst:
                worst, where = rel, group + k
    return worst, where


def torch_equal(a, b):
    import torch

    return torch.equal(a.cpu(), b.cpu())


def _step_losses(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def _check_losses(got, want, label):
    if [s for s, _ in got] != [s for s, _ in want]:
        raise AssertionError(f"{label}: steps {[s for s, _ in got]} != "
                             f"{[s for s, _ in want]}")
    worst = max(abs(a - b) / max(abs(b), 1e-30)
                for (_, a), (_, b) in zip(got, want))
    if not worst <= STEP_LOSS_RTOL:
        raise AssertionError(f"{label}: step loss rel gap {worst:.2e}")
    return worst


def _round_trip(base, label, sets, main=None, full=None):
    """A straight 2-epoch run and 1 epoch + --resume to 2 epochs: the same
    step losses and the same final state (to STATE_RTOL).  `main` is the
    CLI's entry point (train_student's by default) and `full` the run's
    checkpointed state (train/moma.full_state's)."""
    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.train.moma import full_state

    main = main or train_student.main
    full = full or full_state
    with _cut_sets(sets):
        root = SAVE_ROOT
        _set_root(os.path.join(root, label, "straight"))
        s_st, r_st = main(_args(base, 2))
        _set_root(os.path.join(root, label, "resumed"))
        _, r_1 = main(_args(base, 1))
        s_re, r_re = main(_args(base, 2, "--resume"))
        _set_root(root)
    loss_gap = _check_losses(_step_losses(r_re["run_dir"]),
                             _step_losses(r_st["run_dir"]), label)
    if s_re.step != s_st.step or (
            hasattr(s_st, "queue") and s_re.queue.ptr != s_st.queue.ptr):
        raise AssertionError(f"{label}: step / queue pointer differ after "
                             f"the resume")
    gap, where = _state_gap(full(s_re), full(s_st))
    if not gap <= STATE_RTOL:
        raise AssertionError(f"{label}: resumed vs straight state gap "
                             f"{gap:.2e} at {where}")
    return s_re, r_1, r_re, loss_gap, gap, where


class _cut_sets:
    """Cut the synthetic train / val / test sets to (n_train, n_val,
    n_test) images for the runs inside (MoMA, teacher and distillation
    runs)."""

    def __init__(self, sizes):
        self.sizes = sizes

    def __enter__(self):
        from moma_tpu_torch.data.pipeline import ArrayDataset
        from moma_tpu_torch.train import moma as moma_train
        from moma_tpu_torch.train import teacher as teacher_train

        self.full = full = teacher_train.build_datasets
        sizes = self.sizes

        def cut(cfg, syn):
            return tuple(ArrayDataset(ds.images[:n], ds.labels[:n])
                         for ds, n in zip(full(cfg, syn), sizes))

        moma_train.build_datasets = teacher_train.build_datasets = cut

    def __exit__(self, *exc):
        from moma_tpu_torch.train import moma as moma_train
        from moma_tpu_torch.train import teacher as teacher_train

        moma_train.build_datasets = teacher_train.build_datasets = self.full
        return False


def _step_makers():
    """(module, name) of each run's step factory: the MoMA, the vanilla
    and the distillation step."""
    from moma_tpu_torch.train import moma as moma_train
    from moma_tpu_torch.train import student as student_train
    from moma_tpu_torch.train import teacher as teacher_train

    return ((moma_train, "make_moma_train_step"),
            (teacher_train, "make_vanilla_train_step"),
            (student_train, "make_distill_train_step"))


class _wrapped_steps:
    """For the runs inside, the step programs built call `before(state,
    n)` before and `after(state, n)` after their n-th step (counted over
    all of them)."""

    def __init__(self, before=None, after=None):
        self.before, self.after = before, after

    def __enter__(self):
        before, after, done = self.before, self.after, [0]
        self.saved = []
        for mod, name in _step_makers():
            make = getattr(mod, name)
            self.saved.append((mod, name, make))

            def wrapped(*a, _make=make, **kw):
                step = _make(*a, **kw)

                def counted(state, *rest):
                    done[0] += 1
                    if before is not None:
                        before(state, done[0])
                    out = step(state, *rest)
                    if after is not None:
                        after(out[0], done[0])
                    return out
                return counted

            setattr(mod, name, wrapped)

    def __exit__(self, *exc):
        for mod, name, make in self.saved:
            setattr(mod, name, make)
        return False


def _set_root(path):
    global SAVE_ROOT
    SAVE_ROOT = path


def phase_persistence(dev="cuda", image=512, batch=64):
    """The run around the step on the card (parts a-g), then --profile_dir,
    on MAIN_ARGS' model (`image` and `batch` are its size)."""
    import signal

    import torch

    from moma_tpu_torch.cli import test_eval, train_student
    from moma_tpu_torch.core.checkpoint import CheckpointManager
    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.core.profiling import summarize_trace
    from moma_tpu_torch.data import augment as aug
    from moma_tpu_torch.data.histo_augment import make_histo_augment
    from moma_tpu_torch.data.pipeline import Loader, synthetic_dataset
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts
    from moma_tpu_torch.train.loop import evaluate
    from moma_tpu_torch.train.moma import full_state
    from moma_tpu_torch.train.steps import make_eval_step

    t_phase = time.perf_counter()
    root = SAVE_ROOT
    # (a) resume equals straight, cuDNN's default algorithms, then with
    # torch.backends.cudnn.deterministic
    s_re, r_1, r_re, loss_gap, gap, where = _round_trip(
        MAIN_ARGS, "a", PERSIST_SETS)
    # the threshold carried over: the best of epoch 1 (the first run's)
    # and epoch 2, and best_acc.pt rewritten only if epoch 2 beat epoch 1
    ep2 = r_re["epochs"][-1]["val_acc"]
    best_meta = CheckpointManager(os.path.join(r_re["run_dir"], "ckpt")).meta(
        "best_acc")
    if not (r_re["best_acc"] == max(r_1["best_acc"], ep2)
            and best_meta["epoch"] == (2 if ep2 > r_1["best_acc"] else 1)):
        raise AssertionError(f"(a) best_acc threshold not carried: epoch 1 "
                             f"{r_1['best_acc']}, epoch 2 {ep2}, result "
                             f"{r_re['best_acc']}, meta {best_meta}")
    log(f"[persist] (a) 1 epoch + --resume vs 2 straight epochs (2 steps "
        f"an epoch): steps {s_re.step}, queue_ptr {s_re.queue.ptr}, "
        f"step losses max rel gap {loss_gap:.2e} (limit {STEP_LOSS_RTOL}), "
        f"state max rel gap {gap:.2e} at {where} (limit {STATE_RTOL}); "
        f"best_acc {r_re['best_acc']:.2f} carried over the resume")
    torch.backends.cudnn.deterministic = True
    try:
        _, _, _, d_loss, d_gap, d_where = _round_trip(MAIN_ARGS, "a_det",
                                                      PERSIST_SETS)
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"[persist] (a) with torch.backends.cudnn.deterministic: step "
        f"losses max rel gap {d_loss:.2e}, state max rel gap {d_gap:.2e}"
        f"{' at ' + d_where if d_gap else ''}: "
        + ("bit for bit" if d_gap == 0 and d_loss == 0
           else "not bit for bit"))

    # (b) latest onto the card, bit for bit; a save's and a load's time
    ckpt = CheckpointManager(os.path.join(r_re["run_dir"], "ckpt"),
                             map_location=torch.device(dev))
    saved = full_state(s_re)
    restored = ckpt.restore("latest")
    got = dict(_tensors(restored))
    for k, t in _tensors(saved):
        if got[k].device != t.device or not torch.equal(got[k], t):
            raise AssertionError(f"(b) restored {k} differs from the saved")
    sync(dev)
    t0 = time.perf_counter()
    ckpt.save("probe", saved, {"epoch": 0})
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ckpt.restore("probe")
    sync(dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(ckpt.path("probe")) / 1e6
    log(f"[persist] (b) latest.pt restored onto the card: {len(got)} "
        f"tensors equal bit for bit; a checkpoint {mb:.1f} MB, save "
        f"{save_ms:.1f} ms, load onto the card {load_ms:.1f} ms (host clock)")

    # (c) SIGTERM after the first step of a 2-epoch run, then --resume
    def kill_after_first(state, n):
        if n == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    _set_root(os.path.join(root, "c"))
    with _cut_sets(PERSIST_SETS), _wrapped_steps(after=kill_after_first):
        s_c, r_c = train_student.main(_args(MAIN_ARGS, 2))
    meta = CheckpointManager(os.path.join(r_c["run_dir"], "ckpt")).meta(
        "latest")
    with _cut_sets(PERSIST_SETS):
        s_c2, r_c2 = train_student.main(_args(MAIN_ARGS, 2, "--resume"))
    _set_root(root)
    if not (r_c.get("preempted") and s_c.step == 1 and meta == {
            "epoch": 0, "preempted": True, "resume_step": 1}):
        raise AssertionError(f"(c) run not preempted after its first step: "
                             f"step {s_c.step}, meta {meta}")
    steps_c = [s for s, _ in _step_losses(r_c2["run_dir"])]
    if s_c2.step != 4 or steps_c != [1, 2, 3, 4]:
        raise AssertionError(f"(c) resumed run: step {s_c2.step}, logged "
                             f"steps {steps_c}")
    log(f"[persist] (c) SIGTERM after step 1 of 4: latest.meta.json "
        f"{meta}; the --resume run took the 3 remaining steps (logged steps "
        f"{steps_c}, step {s_c2.step})")

    # (d) cli.test_eval over the run dir against an eval computed here
    out = os.path.join(root, "test_stat.json")
    got = test_eval.main([
        "--runs", r_re["run_dir"], "--synthetic", "--model", "effiB0",
        "--n_cls", "4", "--image_size", str(image), "--batch_size",
        str(batch), "--device", dev, "--out", out])
    got = got[os.path.basename(r_re["run_dir"])]
    model = create_model("effiB0", 4).to(dev,
                                         memory_format=torch.channels_last)
    model.load_state_dict(ckpt.restore("best_acc")["student"])
    def norm(x):   # test_eval's --synthetic normalization
        return aug.normalize(x, aug.CIFAR100_MEAN, aug.CIFAR100_STD)

    want = evaluate(model, Loader(synthetic_dataset(max(batch, 128), image,
                                                    4, 1), batch,
                                  train=False),
                    make_eval_step(4, normalize_fn=norm), torch.device(dev),
                    4)
    for k in ("acc", "f1", "conf_mat", "n"):
        if got[k] != want[k]:
            raise AssertionError(f"(d) test_eval {k} {got[k]} != {want[k]}")
    log(f"[persist] (d) cli.test_eval --synthetic --device cuda: acc "
        f"{got['acc']:.2f} f1 {got['f1']:.4f} conf_mat {got['conf_mat']}, "
        f"equal to the phase's own eval of best_acc.pt")

    # (e) one step with --std_pre / --tec_pre the run's best_acc.pt
    best = ckpt.path("best_acc")
    saved_student = ckpt.restore("best_acc")["student"]

    def loaded_before_first(state, n):
        if n != 1:
            return
        for name, net in (("student", state.student),
                          ("teacher", state.teacher)):
            for k, t in net.state_dict().items():
                if not torch.equal(t, saved_student[k]):
                    raise AssertionError(f"(e) {name} {k} is not the saved "
                                         "student's")

    _set_root(os.path.join(root, "e"))
    with _cut_sets((batch,) * 3), _wrapped_steps(before=loaded_before_first):
        s_e, r_e = train_student.main(_args(
            MAIN_ARGS, 1, "--std_pre", best, "--tec_pre", best))
    _set_root(root)
    if not (s_e.step == 1 and math.isfinite(r_e["train"]["loss"])):
        raise AssertionError(f"(e) step {s_e.step}, loss "
                             f"{r_e['train']['loss']}")
    log(f"[persist] (e) --std_pre / --tec_pre {os.path.basename(best)}: "
        f"student and teacher equal the saved student before the step; 1 "
        f"step, loss {r_e['train']['loss']:.4f}")

    # (f) two steps with --image_resize: launches, and the crop's time
    with _cut_sets(PERSIST_SETS):
        reset_launch_counts()
        s_f, r_f = train_student.main(_args(MAIN_ARGS, 1, "--image_resize",
                                            "--crop", "0.2"))
        counts = launch_counts()
    want, _ = expected_launches(s_f, 2)
    for k, v in want.items():
        if counts.get(k, 0) != v:
            raise AssertionError(f"(f) launch count {k}: {counts.get(k, 0)} "
                                 f"!= {v}")
    if not math.isfinite(r_f["train"]["loss"]):
        raise AssertionError(f"(f) loss {r_f['train']['loss']}")
    cfg_f = parse_student_args([a for a in _args(MAIN_ARGS, 1)
                                if a != "--synthetic"] + ["--image_resize"])
    images = torch.randint(0, 256, (batch, image, image, 3),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(8)).to(dev)
    g = torch.Generator().manual_seed(9)
    xf = images.float()
    crop_ms = cuda_time_ms(lambda: aug.random_resized_crop(xf, g, image))
    with_crop = make_histo_augment(cfg_f)
    cfg_f.data.image_resize = False
    without = make_histo_augment(cfg_f)
    aug_crop_ms = cuda_time_ms(lambda: with_crop(images, g))
    aug_ms = cuda_time_ms(lambda: without(images, g))
    log(f"[persist] (f) --image_resize, 2 steps: loss "
        f"{r_f['train']['loss']:.4f}, launches as expected ({counts}); the "
        f"crop ({batch}x{image}^2x3 f32) {crop_ms:.3f} ms a batch; the "
        f"augment with it {aug_crop_ms:.3f} ms, without {aug_ms:.3f} ms "
        f"(device time, median of {TIMING_ITERS})")

    # (g) a --resume round trip of the fused teacher and of MoCoAtt 'all'
    for base, label in ((FUSED_ARGS, "g_fused"), (MOCOATT_ARGS, "g_att")):
        s_g, _, _, g_loss, g_gap, g_where = _round_trip(base, label,
                                                        (batch,) * 3)
        log(f"[persist] (g) {label[2:]}: 1 + 1 epochs (1 step each) vs 2 "
            f"straight: step losses rel gap {g_loss:.2e}, state max rel gap "
            f"{g_gap:.2e} at {g_where}; queue_ptr {s_g.queue.ptr}")

    # --profile_dir: a torch.profiler trace of the first epoch (2 steps)
    trace_dir = os.path.join(root, "trace")
    with _cut_sets(PERSIST_SETS):
        train_student.main(_args(MAIN_ARGS, 1, "--profile_dir", trace_dir))
    top = summarize_trace(trace_dir, top=5)
    if not top:
        raise AssertionError("--profile_dir wrote a trace with no device work")
    log("[persist] --profile_dir, 2 steps: top 5 by device time (ms, "
        "launches): " + "; ".join(f"{n[:100]} {ms:.2f} x{c}"
                                  for n, ms, c in top))
    log(f"[persist] phase wall time {time.perf_counter() - t_phase:.1f} s")


# phase_cross_arch: the EMA copy after one step against alpha * ema + (1 -
# alpha) * student(pre-step), computed here by the same float32 operations:
# 1e-6 of each tensor's largest magnitude
EMA_RTOL = 1e-6


def phase_cross_arch(batch=64):
    """Config #5 through the CLI: 4 steps of CROSS_ARGS (launch counts, the
    fixed teacher bit for bit unchanged, the EMA copy after the first step,
    step time, img/s, peak memory), then a --resume round trip at 1 step an
    epoch (every tensor of the final state, the EMA copy's too) and one
    --mem MoCoST step (memory_s and memory_t take other keys)."""
    import torch

    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.core.config import parse_student_args

    t_phase = time.perf_counter()
    alpha = parse_student_args(
        [a for a in CROSS_ARGS if a != "--synthetic"]).moma.alpha
    seen = {}

    def before(state, n):
        if n == 1:
            seen["teacher"] = {k: v.clone() for k, v in
                               state.teacher.state_dict().items()}
            seen["want"] = [alpha * e.detach() + (1 - alpha) * p.detach()
                            for e, p in zip(state.ema.parameters(),
                                            state.student.parameters())]

    def after(state, n):
        if n == 1:
            seen["ema_gap"] = max(
                float((e - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for e, w in zip(state.ema.parameters(), seen["want"]))
        for k, v in state.teacher.state_dict().items():
            if not torch.equal(v, seen["teacher"][k]):
                raise AssertionError(f"cross-arch step {n} changed the fixed "
                                     f"teacher's {k}")
        seen["steps"] = n

    with _wrapped_steps(before, after):
        counts = phase_main_path(CROSS_ARGS, "cross_arch")
    if not seen["ema_gap"] <= EMA_RTOL:
        raise AssertionError(f"EMA copy after one step: gap {seen['ema_gap']:.2e}"
                             f" of max|want| > {EMA_RTOL}")
    log(f"[cross_arch] fixed teacher bit for bit unchanged over "
        f"{seen['steps']} steps; EMA copy after step 1 within "
        f"{seen['ema_gap']:.2e} of alpha*ema + (1-alpha)*student "
        f"(alpha {alpha}, limit {EMA_RTOL})")

    s_re, _, _, loss_gap, gap, where = _round_trip(CROSS_ARGS, "x_resume",
                                                   (batch,) * 3)
    log(f"[cross_arch] 1 + 1 epochs (1 step each) with --resume vs 2 "
        f"straight: step losses rel gap {loss_gap:.2e}, state max rel gap "
        f"{gap:.2e}{' at ' + where if where else ''} (the EMA copy's "
        f"tensors in it); queue_ptr {s_re.queue.ptr}")

    root = SAVE_ROOT
    _set_root(os.path.join(root, "x_mocost"))
    with _cut_sets((batch,) * 3):
        s_st, r_st = train_student.main(_args(
            with_flags(CROSS_ARGS, mem="MoCoST"), 1))
    _set_root(root)
    ms = s_st.queue.memory["memory_s"][:batch].float()
    mt = s_st.queue.memory["memory_t"][:batch].float()
    diff = float((ms - mt).abs().sum())
    if not (diff > 1e-3 and math.isfinite(r_st["train"]["loss"])):
        raise AssertionError(f"cross-arch MoCoST: memory_s vs memory_t rows "
                             f"differ by {diff}, loss {r_st['train']['loss']}")
    log(f"[cross_arch] --mem MoCoST, 1 step: loss "
        f"{r_st['train']['loss']:.4f}; memory_s and memory_t rows 0-{batch - 1}"
        f" differ by {diff:.3f} (sum |.|: the EMA copy's keys against the "
        f"fixed teacher's)")
    log(f"[cross_arch] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return counts


class _moe_routes:
    """For the forwards inside, every MoE layer's routing
    (models/vit_moe.MoEMLP, patched here): `calls` holds, per layer call,
    the tokens routed, the choices dropped (a device tensor, read after
    the run: no host sync in the step) and the capacity; `choices` the
    expert choices made.  With `replay` (a list of choices, in call
    order, taken again from its start once used up) the layers take those
    instead of their own, and `flips` counts the tokens whose own choices
    differed."""

    def __init__(self, replay=None):
        self.replay, self.calls, self.choices = replay, [], []
        self.flips = 0

    def __enter__(self):
        from moma_tpu_torch.models.vit_moe import MoEMLP

        route, choose = MoEMLP.route, MoEMLP.choose
        self.saved = (route, choose)

        def choose_(m, probs):
            vals, idx = choose(m, probs)
            if self.replay is not None:
                want = self.replay[len(self.choices) % len(self.replay)].to(
                    idx.device)
                self.flips += int((idx != want).any(-1).sum())
                idx = want
                vals = probs.gather(-1, idx)
            self.choices.append(idx)
            return vals, idx

        def route_(m, xf):
            gates, idx, slot, cap = route(m, xf)
            self.calls.append((xf.shape[0], (slot >= cap).sum(), cap))
            return gates, idx, slot, cap

        MoEMLP.route, MoEMLP.choose = route_, choose_
        return self

    def __exit__(self, *exc):
        from moma_tpu_torch.models.vit_moe import MoEMLP

        MoEMLP.route, MoEMLP.choose = self.saved

    def dropped(self, layers, forwards=4):
        """(tokens routed a call, capacity, [dropped choices of each MoE
        block a forward]) over the first `forwards` forwards of a model of
        `layers` MoE blocks."""
        calls = self.calls[:layers * forwards]
        if len(calls) != layers * forwards:
            raise AssertionError(f"{len(self.calls)} MoE layer calls, "
                                 f"expected {layers * forwards} or more")
        per = [0] * layers
        for i, (_, d, _) in enumerate(calls):
            per[i % layers] += int(d)
        return calls[0][0], calls[0][2], [d / forwards for d in per]


def phase_moe():
    """[5b-teachers] (a): config #5 with the MoE ViT-S/16 teacher
    (MOE_ARGS) through the CLI, 4 steps: launch counts (the student's and
    the EMA copy's BatchNorms, as config #5), step time, img/s, peak, the
    fixed teacher's class and the tokens its MoE blocks dropped; then the
    MoE ViT-S/16 trained through cli.train_teacher at 224^2 (4 steps,
    batch 64: no BatchNorm, 2 RandAugment layers a step), the path whose
    gradients run through the router's gates."""
    from moma_tpu_torch.cli import train_teacher

    t_phase = time.perf_counter()
    with _moe_routes() as routes:
        counts = phase_main_path(MOE_ARGS, "cross_moe")
    state = MAIN_RUNS["cross_moe"]["state"]
    layers = len(state.teacher.moe_layers())
    # the fixed teacher's KL forward, one a step
    S, cap, per = routes.dropped(layers)
    if (type(state.teacher).__name__ != "MoEVisionTransformer"
            or len(routes.calls) != 4 * layers):
        raise AssertionError(f"cross_moe: teacher {type(state.teacher)}, "
                             f"{len(routes.calls)} MoE layer calls")
    log(f"[cross_moe] ({CARD}) fixed MoE teacher, {layers} MoE blocks of "
        f"{state.teacher.num_experts} experts (top-{state.teacher.top_k}, "
        f"capacity factor {state.teacher.capacity_factor}): {S} tokens a "
        f"forward, capacity {cap} an expert; tokens dropped a forward by "
        f"block {per} (of {S})")
    MAIN_RUNS.pop("cross_moe")
    del state

    root = SAVE_ROOT
    _set_root(os.path.join(root, "teacher_moe"))
    args = with_flags(TEACHER_ARGS, model=MOE_T, image_size="224")
    with _moe_routes() as routes:
        s_t, _, t_counts = phase_drive(train_teacher.main, args,
                                       "teacher_moe", lambda s: [s.model])
    _set_root(root)
    S, cap, per = routes.dropped(len(s_t.model.moe_layers()))
    log(f"[teacher_moe] ({CARD}) the 4 train steps' forwards, {S} tokens "
        f"each, capacity {cap} an expert: tokens dropped a forward by "
        f"block {per}")
    for k, v in t_counts.items():
        counts[k] = counts.get(k, 0) or v
    log(f"[cross_moe] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return counts


# phase_teacher: scripts/run_vanilla.sh's command line (effiB0, 512^2, batch
# 64, lr 0.05, cosine, wd 1e-4) for one epoch of synthetic data
TEACHER_ARGS = [
    "--dataset", "prostate_hv", "--model", "effiB0", "--batch_size", "64",
    "--image_size", "512", "--epochs", "1", "--learning_rate", "0.05",
    "--cosine", "--weight_decay", "1e-4", "--synthetic", "--device", "cuda",
    "--print_freq", "1",
]
# phase_comparison: scripts/run_comparison.sh's seven command lines, each
# with the script's -c / -d / -b, distilling from phase_teacher's run
COMPARISON_ARGS = [
    "--dataset", "prostate_hv", "--model_s", "effiB0", "--model_t",
    "effiB0", "--batch_size", "64", "--image_size", "512", "--epochs", "1",
    "--learning_rate", "0.05", "--cosine", "--weight_decay", "1e-4",
    "--nce_k", "16384", "--synthetic", "--device", "cuda", "--print_freq",
    "1",
]
COMPARISON = (("kd", "1", "0", "1"), ("hint", "1", "1", "100"),
              ("correlation", "1", "1", "0.02"), ("crd", "1", "1", "0.8"),
              ("attention", "1", "1", "1000"), ("semckd", "1", "0", "50"),
              ("simkd", "0", "0", "1"))


def comparison_args(method, c, d, b, *extra):
    return COMPARISON_ARGS + ["--distill", method, "-c", c, "-d", d, "-b",
                              b, *extra]


def _n_bn(*modules):
    return sum(1 for mod in modules for m in mod.modules()
               if type(m).__name__ == "FusedBatchNorm")


def phase_drive(main, args, label, nets, ra_per_step=2, expect=None):
    """Drive a training CLI (`main`, with `args`) for one epoch of 4 steps:
    finite losses, and the launch counts of its train-mode BatchNorms (the
    modules `nets(state)` returns: every one runs one channel_sums forward
    and one grad_channel_sums backward a step) and of the augment's
    `ra_per_step` RandAugment layers a step, or those `expect(state, n)`
    gives; then steady step time, img/s and peak memory.  Returns (state,
    result, counts)."""
    import torch

    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, result = main(list(args) + ["--save_dir", SAVE_ROOT])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tr = result["train"]
    n = tr["steps"]
    for k in ("loss", "acc1"):
        if not math.isfinite(tr[k]):
            raise AssertionError(f"{label}: train {k} {tr[k]} not finite")
    for k in ("loss", "acc", "f1"):
        if not math.isfinite(result["val"][k]):
            raise AssertionError(f"{label}: val {k} not finite")
    if n != 4:
        raise AssertionError(f"{label} ran {n} steps, expected 4")
    n_bn = _n_bn(*nets(state))
    want = {"channel_sums": n_bn * n, "grad_channel_sums": n_bn * n,
            "ra_layer": ra_per_step * n,
            "ra_layer_kernels": 2 * ra_per_step * n,
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "k1_expand_stats": 0, "k2_depthwise": 0, "k4_project": 0}
    if expect is not None:
        want = expect(state, n)
    log(f"[{label}] launch counts {counts} (expected {want}, {n_bn} "
        f"train-mode BNs)")
    for k, v in want.items():
        if counts.get(k, 0) != v:
            raise AssertionError(f"{label}: launch count {k}: "
                                 f"{counts.get(k, 0)} != {v}")
    steady = statistics.median(tr["batch_times"][1:])
    log(f"[{label}] {n} steps + eval in {wall:.1f} s; train loss "
        f"{tr['loss']:.4f}, val acc {result['val']['acc']:.2f}; step times "
        f"(s) {[round(t, 4) for t in tr['batch_times']]}; steady step "
        f"{steady * 1e3:.1f} ms = {64 / steady:.1f} img/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return state, result, counts


def phase_trace(main, args, label):
    """One epoch of 2 steps of a path under --profile_dir: the device's
    busy time over the traced span, its idle share and the top 5 device
    operations (the steps' host clock runs slower under the profiler)."""
    from moma_tpu_torch.core.profiling import trace_summary

    trace_dir = os.path.join(SAVE_ROOT, "trace_" + label)
    with _cut_sets(PERSIST_SETS):
        main(_args(args, 1, "--profile_dir", trace_dir))
    t = trace_summary(trace_dir, top=5)
    if not t["device_intervals"]:
        raise AssertionError(f"{label}: the trace holds no device work")
    log(f"[{label}] --profile_dir, 2 steps: device busy "
        f"{t['busy_us'] / 1e3:.1f} of {t['span_us'] / 1e3:.1f} ms traced "
        f"(idle {100 * t['idle_share']:.1f}%), {t['device_intervals']} "
        f"device intervals; top 5 (ms): "
        + "; ".join(f"{n[:80]} {ms:.2f}" for n, ms in t["top_kernels_ms"]))


def _relu_sides():
    """A TorchFunctionMode that records which side of its kinks every ReLU
    (and relu6's clamp(0, 6)) input takes (`sides` None), or makes them
    take the recorded sides, in call order: relu(x) becomes x * side."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class ReluSides(TorchFunctionMode):
        def __init__(self, sides=None):
            super().__init__()
            self.replay = sides is not None
            self.sides = sides if self.replay else []
            self.calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            relu = func in (F.relu, torch.relu)
            relu6 = (func is torch.Tensor.clamp and not kwargs
                     and tuple(args[1:]) == (0.0, 6.0))
            if not (relu or relu6):
                return func(*args, **kwargs)
            x = args[0]
            if not self.replay:
                side = (x > 0).to(torch.int8)
                if relu6:
                    side += (x >= 6.0).to(torch.int8)
                self.sides.append(side.detach().cpu())
                return func(*args, **kwargs)
            side = self.sides[self.calls].to(x.device)
            self.calls += 1
            if relu:
                return x * side.to(x.dtype)
            return torch.where(side == 1, x, (side == 2).to(x.dtype) * 6.0)

    return ReluSides


def _cpu_vs_card(build, batch, label, nets, extra=None, relu_sides=False):
    """One step (augmentation included) on the CPU (plain versions) and
    on the card (kernels), built by `build(device) -> (state, step)` from
    the same seed, on the same batch and draws, f32 with TF32 off: the
    losses within 1e-3, each tensor of the modules `nets(state)` within
    1e-3 of its largest magnitude (floored at 1e-3 of the largest of
    all), and the tensors `extra(state)` within 1e-3 of theirs.  With
    `relu_sides` every ReLU input on the card takes the side of 0 (and
    relu6's of 6) that it took on the CPU: one input within rounding of a
    kink that falls the other way moves every gradient before it, by
    percents for the BatchNorm biases a first step sets, which no
    tolerance of float rounding covers."""
    import contextlib

    import torch

    from moma_tpu_torch.train.loop import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    sides, flips = None, 0
    try:
        for dev in ("cpu", "cuda"):
            device = torch.device(dev)
            state, step = build(device)
            mode = (_relu_sides()(sides) if relu_sides
                    else contextlib.nullcontext())
            with mode:
                out[dev] = step(state, to_device(batch, device),
                                torch.Generator().manual_seed(5))
            if relu_sides:
                if dev == "cpu":
                    sides = mode.sides
                elif mode.calls != len(sides):
                    raise AssertionError(f"{label}: {mode.calls} ReLUs on "
                                         f"the card, {len(sides)} on the CPU")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        if k not in mc:
            continue
        a, b = float(mc[k]), float(mg[k])
        if not abs(a - b) <= 1e-3 * abs(a) + 1e-5:
            raise AssertionError(f"{label} parity {k}: cpu {a} vs cuda {b}")
    pairs = [(p.detach(), q.detach().cpu()) for a, b in zip(nets(sc),
                                                             nets(sg))
             for p, q in zip(a.parameters(), b.parameters())]
    floor = 1e-3 * max(float(p.abs().max()) for p, _ in pairs)
    worst = max(float((p - q).abs().max()) / max(float(p.abs().max()), floor)
                for p, q in pairs)
    xerr = 0.0
    for p, q in zip(extra(sc) if extra else (), extra(sg) if extra else ()):
        xerr = max(xerr, float((p - q.cpu()).abs().max())
                   / max(float(p.abs().max()), 1e-30))
    if not (worst <= 1e-3 and xerr <= 1e-3):
        raise AssertionError(f"{label} parity: params max rel {worst:.2e}, "
                             f"extra {xerr:.2e}")
    log(f"[parity] {label} f32 step cpu vs cuda: loss "
        f"{float(mc['loss']):.6f} vs {float(mg['loss']):.6f}; params max rel "
        f"diff {worst:.2e}" + (f"; extra state {xerr:.2e}" if extra else "")
        + (f"; {len(sides)} ReLUs on the CPU's sides" if relu_sides else ""))


def _small_batch(n_data=16):
    import numpy as np

    rs = np.random.RandomState(0)
    idx = rs.permutation(n_data)[:4].astype(np.int32)
    cidx = rs.randint(0, n_data, (4, 17)).astype(np.int32)
    cidx[:, 0] = idx
    return {"image": rs.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8),
            "label": rs.randint(0, 4, (4,)).astype(np.int32),
            "index": idx, "contrast_idx": cidx}


def phase_teacher(batch=64):
    """scripts/run_vanilla.sh through cli.train_teacher (4 steps), then
    its best_acc.pt into one MoMA step (--tec_pre) and one kd step
    (--path_t), the loaded teacher bit for bit the run's; a --resume
    round trip of the teacher run; a 64^2 vanilla step on the CPU and the
    card.  Returns (best_acc.pt, counts)."""
    import torch

    from moma_tpu_torch.cli import train_student, train_teacher
    from moma_tpu_torch.core.config import parse_teacher_args
    from moma_tpu_torch.train.steps import make_vanilla_train_step
    from moma_tpu_torch.train.teacher import (augment_fns,
                                              build_teacher_state,
                                              teacher_full_state)

    t_phase = time.perf_counter()
    root = SAVE_ROOT
    _set_root(os.path.join(root, "teacher"))
    state, result, counts = phase_drive(
        train_teacher.main, TEACHER_ARGS, "teacher", lambda s: [s.model])
    _set_root(root)
    phase_trace(train_teacher.main, TEACHER_ARGS, "teacher")
    best = os.path.join(result["run_dir"], "ckpt", "best_acc.pt")
    saved = torch.load(best, map_location="cpu", weights_only=True)[
        "teacher"]

    def loaded(state, n):
        if n == 1:
            for k, t in state.teacher.state_dict().items():
                if not torch_equal(t, saved[k]):
                    raise AssertionError(f"loaded teacher {k} is not the "
                                         "teacher run's")

    kd_args = comparison_args("kd", "1", "0", "1")
    for label, base, flag in (("tec_pre", MAIN_ARGS, "--tec_pre"),
                              ("path_t", kd_args, "--path_t")):
        _set_root(os.path.join(root, label))
        with _cut_sets((batch,) * 3), _wrapped_steps(before=loaded):
            s_l, r_l = train_student.main(_args(base, 1, flag, best))
        _set_root(root)
        if not (s_l.step == 1 and math.isfinite(r_l["train"]["loss"])):
            raise AssertionError(f"{label}: step {s_l.step}, loss "
                                 f"{r_l['train']['loss']}")
        log(f"[teacher] {flag} {os.path.basename(best)} into one "
            f"{'MoMA' if label == 'tec_pre' else 'kd'} step: the teacher "
            f"equals the teacher run's bit for bit; loss "
            f"{r_l['train']['loss']:.4f}")

    # the round trip at a step learning rate: a cosine schedule over 1
    # epoch is another run than the first epoch of one over 2
    s_re, _, _, loss_gap, gap, where = _round_trip(
        [a for a in TEACHER_ARGS if a != "--cosine"], "t_resume",
        PERSIST_SETS, main=train_teacher.main, full=teacher_full_state)
    log(f"[teacher] 1 + 1 epochs (2 steps each) with --resume vs 2 straight: "
        f"step losses rel gap {loss_gap:.2e}, state max rel gap {gap:.2e}"
        f"{' at ' + where if where else ''}; step {s_re.step}")

    cfg = parse_teacher_args([
        "--dataset", "prostate_hv", "--model", "effiB0", "--image_size",
        "64", "--batch_size", "4", "--fp32", "--epochs", "1"])
    _cpu_vs_card(lambda dev: (build_teacher_state(cfg, dev, 4, 0),
                              make_vanilla_train_step(augment_fns(cfg)[0])),
                 _small_batch(), "vanilla", lambda s: [s.model])
    log(f"[teacher] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return best, counts


def phase_comparison(teacher_best):
    """scripts/run_comparison.sh's seven methods through
    cli.train_student with --path_t the teacher run's best_acc.pt (4
    steps each), then a 64^2 step of each of the 17 methods on the CPU
    and the card.  Returns the launch counts of the first method."""
    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.core.config import DISTILLERS, parse_student_args
    from moma_tpu_torch.train.distill import make_distill_train_step
    from moma_tpu_torch.train.student import build_distill_state
    from moma_tpu_torch.train.teacher import augment_fns

    t_phase = time.perf_counter()
    root = SAVE_ROOT
    first = None
    for method, c, d, b in COMPARISON:
        _set_root(os.path.join(root, "cmp_" + method))
        state, result, counts = phase_drive(
            train_student.main,
            comparison_args(method, c, d, b, "--path_t", teacher_best),
            method, lambda s: [s.student, s.aux])
        _set_root(root)
        first = first or counts
        if method == "crd":
            # the plain run phase_nccl_one_rank's crd run is held to
            n, n_bn = result["train"]["steps"], _n_bn(state.student,
                                                       state.aux)
            CMP_RUNS["crd"] = {
                "teacher": teacher_best, "queue_ptr": None,
                "launches": {"channel_sums": n_bn * n,
                             "grad_channel_sums": n_bn * n,
                             "ra_layer": 2 * n},
                "losses": _step_losses(result["run_dir"]),
                "steady": statistics.median(
                    result["train"]["batch_times"][1:])}
            z = (float(state.extra.z_v1), float(state.extra.z_v2))
            if not all(math.isfinite(v) and v > 0 for v in z):
                raise AssertionError(f"crd: Z {z}")
            log(f"[crd] banks {tuple(state.extra.v1.shape)} x 2 f32, Z "
                f"{z[0]:.4g} / {z[1]:.4g}")
        del state, result
    phase_trace(train_student.main,
                comparison_args("crd", "1", "1", "0.8", "--path_t",
                                teacher_best), "crd")

    for method in DISTILLERS:
        cfg = parse_student_args([
            "--distill", method, "--dataset", "prostate_hv", "--model_s",
            "effiB0", "--model_t", "effiB0", "--image_size", "64",
            "--batch_size", "4", "--nce_k", "16", "--feat_dim", "32", "-b",
            "1", "--fp32", "--epochs", "1"])

        def build(dev, cfg=cfg):
            state, distiller = build_distill_state(cfg, dev, 4, 0, 16)
            return state, make_distill_train_step(distiller,
                                                  augment_fns(cfg)[0])

        _cpu_vs_card(build, _small_batch(), method,
                     lambda s: [s.student, s.aux],
                     (lambda s: [s.extra.v1, s.extra.v2]) if method == "crd"
                     else None)
    log(f"[comparison] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return first

# phase_comparison_ranks: (a) run_comparison.sh's seven command lines on
# two gloo ranks sharing the card (32 rows a rank, RANK_SETS); (b) the 17
# methods' 64^2 f32 step on 2 ranks against one process, to DP_RTOL
CMP_SMALL = ["--dataset", "prostate_hv", "--model_s", "effiB0", "--model_t",
             "effiB0", "--image_size", "64", "--batch_size", "8", "--nce_k",
             "16", "--feat_dim", "32", "-b", "1", "--fp32", "--epochs", "1"]
CMP_SMALL_DATA = 16
# kdsvd's step is ill-conditioned (SVD gradients of near-equal singular
# values): it is held to this many times the one-process step's own
# response to a 1e-7 relative change of its input, measured in the run
NOISE_FACTOR = 10.0
CMP_RUNS = {}


def _cmp_small_cases():
    from moma_tpu_torch.core.config import DISTILLERS

    return [(m, m, 1) for m in DISTILLERS] + [("crd_accum2", "crd", 2)]


def _cmp_small_batch():
    import numpy as np

    rs = np.random.RandomState(0)
    idx = rs.permutation(CMP_SMALL_DATA)[:8].astype(np.int32)
    cidx = rs.randint(0, CMP_SMALL_DATA, (8, 17)).astype(np.int32)
    cidx[:, 0] = idx
    return {"image": rs.randn(8, 64, 64, 3).astype(np.float32),
            "label": rs.randint(0, 4, (8,)).astype(np.int32),
            "index": idx, "contrast_idx": cidx}


def _distill_tensors(state):
    """The distillation state's student, aux modules and CRD banks on the
    CPU."""
    out = {"student": {k: v.detach().cpu()
                       for k, v in state.student.state_dict().items()},
           "aux": {k: v.detach().cpu()
                   for k, v in state.aux.state_dict().items()}}
    if state.extra is not None:
        out["extra"] = {k: v.detach().cpu()
                        for k, v in state.extra.state_dict().items()}
    return out


def _digest(tensors):
    """A hash of every tensor's bytes, in path order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for path, t in _tensors(tensors):
        h.update(path.encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _cmp_small_step(method, accum, dev, scale=1.0):
    """One step of CMP_SMALL's `method` at --grad_accum `accum` on `dev`
    from build_distill_state's seeded weights, no augmentation, on this
    data rank's rows of _cmp_small_batch (its share of each microbatch),
    the images times `scale`; returns (metrics, the state's tensors on the
    CPU)."""
    import torch

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.core.mesh import data_axis, rank_rows
    from moma_tpu_torch.train.distill import make_distill_train_step
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.student import build_distill_state

    cfg = parse_student_args(CMP_SMALL + ["--distill", method, "--grad_accum",
                                          str(accum), "--device", dev])
    state, distiller = build_distill_state(cfg, torch.device(dev), 4, 0,
                                           CMP_SMALL_DATA)
    step = make_distill_train_step(distiller, None, accum)
    ax = data_axis()
    batch = _cmp_small_batch()
    batch["image"] = batch["image"] * scale
    rows = {k: rank_rows(v, ax.rank, ax.world, accum)
            for k, v in batch.items()}
    state, m = step(state, to_device(rows, torch.device(dev)),
                    torch.Generator().manual_seed(5))
    return {k: float(v) for k, v in m.items()}, _distill_tensors(state)


def _rank_comparison(rank, world, save_root, runs, dev):
    """(a) cli.train_student for each (method, args) of `runs` on this
    rank's half of each global batch (_rank_runs, and a hash of the final
    state); (b) each of _cmp_small_cases' 64^2 f32 steps (TF32 off):
    metrics and the state's hash, and rank 0's state."""
    import torch

    out = {"full": _rank_runs(
        save_root, [(method, args + ["--trial", f"dp2_{method}"])
                    for method, args in runs],
        lambda state, result: {"digest": _digest(_distill_tensors(state))}),
        "small": {}}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, method, accum in _cmp_small_cases():
        metrics, tensors = _cmp_small_step(method, accum, dev)
        out["small"][name] = {"metrics": metrics, "digest": _digest(tensors)}
        if rank == 0:
            out["small"][name]["state"] = tensors
    return out


def phase_comparison_ranks(teacher_best, dev="cuda", runs=None):
    """The comparison distillers on two ranks sharing the card (spawned
    gloo processes, one world for the phase): (a) run_comparison.sh's
    seven command lines (COMPARISON; or `runs`, (method, args) pairs)
    through cli.train_student, 32 rows a rank of the global 64, 2 steps:
    each rank's step times, peak memory, launches a step of ra_layer,
    channel_sums and grad_channel_sums (the student's and the aux
    modules' BatchNorms, synced), the bytes gathered and reduced in a
    step, and the two ranks' final states (student, aux modules, CRD
    banks) equal bit for bit; (b) each of the 17 methods' 64^2 f32 step
    (and crd at --grad_accum 2) on the 2 ranks against the one-process
    step in this process, TF32 off: losses and every tensor to DP_RTOL of
    scale (kdsvd to NOISE_FACTOR times its own response to a 1e-7 change
    of its input), the ranks bit for bit.  Two ranks on one card give no
    data-parallel speed: (a)'s times are those of two processes taking
    turns on one device.  Returns rank 0's launch counts of (a)'s first
    method."""
    import torch

    from moma_tpu_torch.core.mesh import spawn_ranks

    t_phase = time.perf_counter()
    if runs is None:
        runs = [(m, comparison_args(m, c, d, b, "--path_t", teacher_best))
                for m, c, d, b in COMPARISON]
    save = os.path.join(SAVE_ROOT, "cmp2")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        ranks = spawn_ranks(_rank_comparison, 2, (save, runs, dev),
                            backend="gloo", timeout_s=RANK_TIMEOUT_S)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for method, args in runs:
        a, b = ranks[0]["full"][method], ranks[1]["full"][method]
        if not (a["digest"] == b["digest"] and a["loss"] == b["loss"]
                and math.isfinite(a["loss"])):
            raise AssertionError(f"cmp2 {method}: the ranks' states differ "
                                 f"or diverge ({a['loss']} / {b['loss']})")
        n, n_bn = len(a["batch_times"]), a["n_bn"]
        want = ({"channel_sums": n_bn * n, "grad_channel_sums": n_bn * n,
                 "ra_layer": 2 * n} if dev == "cuda" else {})
        B = int(args[args.index("--batch_size") + 1])
        for r, res in enumerate((a, b)):
            for k, v in want.items():
                if res["launches"].get(k, 0) != v:
                    raise AssertionError(
                        f"cmp2 {method} rank {r}: launch count {k}: "
                        f"{res['launches'].get(k, 0)} != {v}")
            steady = statistics.median(res["batch_times"][1:])
            log(f"[cmp2] {method} rank {r}: {B // 2} rows of {B}, steady "
                f"step {steady * 1e3:.1f} ms, step times (s) "
                f"{[round(t, 4) for t in res['batch_times']]}, peak "
                f"{res['peak'] / 2 ** 30:.2f} GiB; a step: "
                + ", ".join(f"{k} {res['launches'].get(k, 0) // n}" for k in
                            ("ra_layer", "channel_sums", "grad_channel_sums"))
                + f" ({n_bn} train-mode BNs)")
        c = a["comm_step"]
        log(f"[cmp2] {method}: one step's collectives on a rank: "
            f"{c.get('all_gather', 0)} all_gather, "
            f"{c.get('all_gather_bytes', 0) / 1e3:.1f} kB sent in; "
            f"{c.get('all_reduce', 0)} all_reduce, "
            f"{c.get('all_reduce_bytes', 0) / 1e6:.2f} MB reduced; train "
            f"loss {a['loss']:.4f}, val acc {a['val_acc']:.2f}; final "
            f"states of the ranks bit for bit")

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        worst_all = 0.0
        for name, method, accum in _cmp_small_cases():
            a, b = ranks[0]["small"][name], ranks[1]["small"][name]
            if a["digest"] != b["digest"] or a["metrics"] != b["metrics"]:
                raise AssertionError(f"cmp2 small {name}: ranks differ")
            want = _cmp_small_step(method, accum, dev)
            tol, note = DP_RTOL, ""
            if method == "kdsvd":
                nudged = _cmp_small_step(method, accum, dev, 1 + 1e-7)
                noise = _state_gap(nudged[1], want[1])[0]
                tol = max(DP_RTOL, NOISE_FACTOR * noise)
                note = (f"; its own response to a 1e-7 input change "
                        f"{noise:.2e}, held to {tol:.2e}")
            for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
                x, y = a["metrics"][k], want[0][k]
                if not abs(x - y) <= DP_RTOL * abs(want[0]["loss"]) + 1e-6:
                    raise AssertionError(f"cmp2 small {name}: {k} {x} vs "
                                         f"{y}")
            gap, where = _state_gap(a["state"], want[1])
            if not gap <= tol:
                raise AssertionError(f"cmp2 small {name}: state gap "
                                     f"{gap:.2e} at {where}")
            if method != "kdsvd":
                worst_all = max(worst_all, gap)
            log(f"[cmp2] 2-rank {name} vs one process, 64^2 f32: loss "
                f"{a['metrics']['loss']:.6f} vs {want[0]['loss']:.6f}; state "
                f"max rel gap {gap:.2e} at {where}{note}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    log(f"[cmp2] two ranks share one card: their step times are those of "
        f"two processes taking turns, no data-parallel speed; the 64^2 "
        f"oracles' largest gap {worst_all:.2e} (kdsvd apart); phase wall "
        f"time {time.perf_counter() - t_phase:.1f} s")
    return ranks[0]["full"][runs[0][0]]["launches"]


# phase_zoo: the CLIs' default run on CIFAR-100 (moma_tpu/core/config.py
# defaults: 240 epochs, lr 0.05 at 150/180/210, wd 5e-4, batch 64), on a
# seeded file in the canonical pickle layout at the real split sizes
CIFAR_SPLITS = (50000, 10000)
CIFAR_TEACHER_ARGS = [
    "--dataset", "cifar100", "--model", "resnet32x4", "--batch_size", "64",
    "--epochs", "1", "--device", "cuda", "--print_freq", "1",
]
CIFAR_STUDENT_ARGS = [
    "--dataset", "cifar100", "--batch_size", "64", "--epochs", "1",
    "--device", "cuda", "--print_freq", "1",
]
# resnet32x4 -> resnet8x4 (the defaults); kd and crd with
# scripts/run_comparison.sh's -c / -d / -b, MoMA with its defaults
CIFAR_STUDENTS = (("kd", ["-c", "1", "-d", "0", "-b", "1"]),
                  ("crd", ["-c", "1", "-d", "1", "-b", "0.8"]),
                  ("moma", []))
CIFAR_TEACHER_BNS = 34
# one name per backbone family at full width, batch 64: the CIFAR nets at
# 32^2, the ImageNet ones at 224^2
ZOO_SWEEP = (("resnet32x4", 32), ("wrn_40_2", 32), ("vgg13", 32),
             ("MobileNetV2", 32), ("ShuffleV1", 32), ("ShuffleV2", 32),
             ("ResNet50", 224), ("resnext50_32x4d", 224),
             ("MobileNetV2_Imagenet", 224), ("ShuffleV2_Imagenet", 224))
# the BN reductions at the zoo's 32^2 shapes, batch 64: the CIFAR ResNets'
# widths and the odd ones (MobileNetV2 half's 8 and 12, ShuffleV1's 54 and
# 216, ShuffleV2's 116), whose bf16 rows are no multiple of 16 bytes
ZOO_BN_SHAPES = [(64, 32, 32, c) for c in (32, 64, 128, 256, 8, 12, 54,
                                            116, 216)]
ZOO_BN_TIMED = [(64, 32, 32, 256), (64, 32, 32, 64)]


class _cap_steps:
    """Loaders inside yield at most `n` batches an epoch (train) and
    `n_eval` (eval), their datasets kept whole (CRD sizes its banks from
    the train split)."""

    def __init__(self, n, n_eval=4):
        self.n, self.n_eval = n, n_eval

    def __enter__(self):
        from moma_tpu_torch.data.pipeline import Loader

        self.saved = Loader.__len__, Loader.__iter__
        length, it = self.saved
        n, n_eval = self.n, self.n_eval

        def capped_len(ld):
            return min(length(ld), n if ld.train else n_eval)

        def capped_iter(ld):
            stop = (n - ld.start_batch) if ld.train else n_eval
            for i, batch in enumerate(it(ld)):
                if i >= stop:
                    return
                yield batch

        Loader.__len__, Loader.__iter__ = capped_len, capped_iter

    def __exit__(self, *exc):
        from moma_tpu_torch.data.pipeline import Loader

        Loader.__len__, Loader.__iter__ = self.saved
        return False


def phase_zoo_bn_kernels(results):
    """channel_sums / grad_channel_sums at the zoo's 32^2 shapes, f32 and
    bf16, against their plain versions (1e-4 of sum|.|); then at
    ZOO_BN_TIMED bf16 the kernels' device times beside their bound (bytes
    at 3.35 TB/s), the plain versions' and torch.batch_norm_stats /
    batch_norm_backward_reduce's at the same shape."""
    import torch

    from moma_tpu_torch.ops import fused_bn as FB

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for shape in ZOO_BN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(
                dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            mean = x.float().mean((0, 1, 2))
            bounds = ((x.float().abs().sum((0, 1, 2)),
                       (x.float() ** 2).sum((0, 1, 2))),
                      (dy.float().abs().sum((0, 1, 2)),
                       (dy.float() * (x.float() - mean)).abs().sum(
                           (0, 1, 2))))
            for name, got, want, bound in (
                    ("channel_sums", FB.channel_sums(x),
                     FB.channel_sums_plain(x), bounds[0]),
                    ("grad_channel_sums", FB.grad_channel_sums(dy, x, mean),
                     FB.grad_channel_sums_plain(dy, x, mean), bounds[1])):
                rel = max(float(((g - w).abs() / (b + 1e-6)).max())
                          for g, w, b in zip(got, want, bound))
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"],
                    max(float((g - w).abs().max())
                        for g, w in zip(got, want)))
                if not rel <= BN_RTOL:
                    raise AssertionError(f"{name} {shape} {dtype}: error "
                                         f"{rel:.2e} of sum|.|")
    log(f"[zoo] channel_sums and grad_channel_sums agree with their plain "
        f"versions within {BN_RTOL} of sum|.| at {len(ZOO_BN_SHAPES)} 32^2 "
        "shapes (C = 32, 64, 128, 256, 8, 12, 54, 116, 216), f32 and bf16")
    for shape in ZOO_BN_TIMED:
        x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        mean = x.float().mean((0, 1, 2))
        invstd = torch.rsqrt(x.float().var((0, 1, 2)) + 1e-5)
        weight = torch.ones_like(mean)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        nbytes = x.numel() * x.element_size()
        for name, kern, plain, lib, nb in (
                ("channel_sums", lambda: FB.channel_sums(x),
                 lambda: FB.channel_sums_plain(x),
                 lambda: torch.batch_norm_stats(xn, 1e-5), nbytes),
                ("grad_channel_sums",
                 lambda: FB.grad_channel_sums(dy, x, mean),
                 lambda: FB.grad_channel_sums_plain(dy, x, mean),
                 lambda: torch.batch_norm_backward_reduce(
                     dyn, xn, mean, invstd, weight, True, True, True),
                 2 * nbytes)):
            ms, plain_ms, lib_ms = (cuda_time_ms(f)
                                    for f in (kern, plain, lib))
            bound = nb / HBM_BYTES_PER_S * 1e3
            log(f"[zoo] {name} {shape} bf16: kernel {ms:.4f} ms, bound "
                f"{bound:.4f} ms (bytes), plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms")


def _zoo_batch(size, n_cls, batch=4, seed=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    return {"image": rs.randint(0, 256, (batch, size, size, 3),
                                dtype=np.uint8),
            "label": rs.randint(0, n_cls, (batch,)).astype(np.int32)}


def _zoo_cfg(name, size, batch, *extra):
    from moma_tpu_torch.core.config import parse_teacher_args

    return parse_teacher_args([
        "--dataset", "synthetic", "--model", name, "--image_size",
        str(size), "--batch_size", str(batch), "--epochs", "1", *extra])


def phase_zoo_sweep(batch=64):
    """One vanilla step of each ZOO_SWEEP net at full width (bf16, batch
    64; 3 steps, the last timed): finite loss, channel_sums and
    grad_channel_sums launches equal to the net's BatchNorms, every
    BatchNorm input channels_last; ShuffleV1 / ShuffleV2's copies in a
    profiled step.  Then one step of each at 32^2 (64^2 for the ImageNet
    family), batch 4, f32, on the CPU and the card."""
    import torch

    from moma_tpu_torch.ops.fused_bn import FusedBatchNorm
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.steps import make_vanilla_train_step
    from moma_tpu_torch.train.teacher import augment_fns, build_teacher_state

    dev = torch.device("cuda")
    for name, size in ZOO_SWEEP:
        cfg = _zoo_cfg(name, size, batch)
        torch.cuda.reset_peak_memory_stats()
        state = build_teacher_state(cfg, dev, 4, 0)
        step = make_vanilla_train_step(augment_fns(cfg)[0])
        n_bn = _n_bn(state.model)
        bad = []
        for m in state.model.modules():
            if isinstance(m, FusedBatchNorm):
                m.register_forward_pre_hook(lambda m, a: bad.append(1) if (
                    a[0].ndim == 4 and not a[0].is_contiguous(
                        memory_format=torch.channels_last)) else None)
        b = to_device(_zoo_batch(size, cfg.model_s.n_cls, batch), dev)
        g = torch.Generator().manual_seed(0)
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
            state, m = step(state, b, g)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if not math.isfinite(loss):
            raise AssertionError(f"zoo {name}: loss {loss}")
        for k in ("channel_sums", "grad_channel_sums"):
            if counts.get(k, 0) != n_bn:
                raise AssertionError(f"zoo {name}: {k} {counts.get(k, 0)} "
                                     f"launches, {n_bn} BatchNorms")
        if bad:
            raise AssertionError(f"zoo {name}: {len(bad)} BatchNorm inputs "
                                 "not channels_last")
        copies = ""
        if name.startswith("Shuffle"):
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                state, m = step(state, b, g)
                torch.cuda.synchronize()
            ops = {e.key: e.count for e in prof.key_averages()}
            copies = (f"; one profiled step: aten::copy_ "
                      f"{ops.get('aten::copy_', 0)}, aten::contiguous "
                      f"{ops.get('aten::contiguous', 0)}, aten::clone "
                      f"{ops.get('aten::clone', 0)}, aten::cat "
                      f"{ops.get('aten::cat', 0)}, aten::stack "
                      f"{ops.get('aten::stack', 0)}")
        log(f"[zoo] {name} @ {size}^2, batch {batch}, bf16: one step "
            f"{ms:.1f} ms (host clock, third step), loss {loss:.4f}, "
            f"{n_bn} BatchNorms = channel_sums {counts['channel_sums']} = "
            f"grad_channel_sums {counts['grad_channel_sums']}, every BN "
            f"input channels_last, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB{copies}")
        del state, step, b
    for name, size in ZOO_SWEEP:
        size = 32 if size == 32 else 64
        cfg = _zoo_cfg(name, size, 4, "--fp32")
        _cpu_vs_card(lambda d, cfg=cfg: (
            build_teacher_state(cfg, d, 4, 0),
            make_vanilla_train_step(augment_fns(cfg)[0])),
            _zoo_batch(size, cfg.model_s.n_cls), f"zoo {name} {size}^2",
            lambda s: [s.model], relu_sides=True)


def phase_zoo(results):
    """CIFAR-100 and the model zoo: the BN kernels at the zoo's shapes;
    resnet32x4 through cli.train_teacher on a seeded CIFAR-100 file at the
    real split sizes (4 steps: 34 channel_sums and grad_channel_sums a
    step, no RandAugment; 2 steps under --profile_dir; a --resume round
    trip), then kd, crd and MoMA students of resnet8x4 from its
    best_acc.pt (4 steps each; the loaded teacher bit for bit the run's),
    then the backbone sweep.  Returns the teacher run's launch counts."""
    import torch

    from moma_tpu_torch.cli import train_student, train_teacher
    from moma_tpu_torch.data.cifar import write_cifar100
    from moma_tpu_torch.train.teacher import teacher_full_state

    t_phase = time.perf_counter()
    phase_zoo_bn_kernels(results)
    root = SAVE_ROOT
    data_dir = os.path.join(root, "cifar")
    t0 = time.perf_counter()
    write_cifar100(data_dir, *CIFAR_SPLITS, seed=0)
    log(f"[zoo] seeded CIFAR-100 pickle ({CIFAR_SPLITS[0]} / "
        f"{CIFAR_SPLITS[1]} images) written in "
        f"{time.perf_counter() - t0:.1f} s")
    t_args = CIFAR_TEACHER_ARGS + ["--data_dir", data_dir]
    _set_root(os.path.join(root, "cifar_teacher"))
    with _cap_steps(4):
        state, result, counts = phase_drive(
            train_teacher.main, t_args, "cifar_teacher",
            lambda s: [s.model], ra_per_step=0)
    _set_root(root)
    if _n_bn(state.model) != CIFAR_TEACHER_BNS:
        raise AssertionError(f"resnet32x4 has {_n_bn(state.model)} "
                             f"BatchNorms, not {CIFAR_TEACHER_BNS}")
    del state
    phase_trace(train_teacher.main, t_args, "cifar_teacher")
    s_re, _, _, loss_gap, gap, where = _round_trip(
        t_args, "cifar_t_resume", PERSIST_SETS, main=train_teacher.main,
        full=teacher_full_state)
    log(f"[cifar_teacher] 1 + 1 epochs (2 steps each) with --resume vs 2 "
        f"straight: step losses rel gap {loss_gap:.2e}, state max rel gap "
        f"{gap:.2e}{' at ' + where if where else ''}; step {s_re.step}")
    del s_re
    best = os.path.join(result["run_dir"], "ckpt", "best_acc.pt")
    saved = torch.load(best, map_location="cpu", weights_only=True)[
        "teacher"]

    def loaded(state, n):
        if n == 1:
            for k, t in state.teacher.state_dict().items():
                if not torch_equal(t, saved[k]):
                    raise AssertionError(f"loaded teacher {k} is not the "
                                         "teacher run's")

    for method, weights in CIFAR_STUDENTS:
        args = CIFAR_STUDENT_ARGS + ["--data_dir", data_dir, "--distill",
                                     method, *weights, "--path_t", best]
        _set_root(os.path.join(root, "cifar_" + method))
        with _cap_steps(4), _wrapped_steps(before=loaded):
            if method == "moma":
                state, result, _ = phase_drive(
                    train_student.main, args, "cifar_moma",
                    lambda s: [s.student],
                    expect=lambda s, n: expected_launches(s, n, ra=0)[0])
                if state.ema is None:
                    raise AssertionError("resnet32x4 -> resnet8x4 MoMA is "
                                         "not in cross-arch EmaTec mode")
            else:
                state, result, _ = phase_drive(
                    train_student.main, args, "cifar_" + method,
                    lambda s: [s.student, s.aux], ra_per_step=0)
        _set_root(root)
        if method == "crd":
            if tuple(state.extra.v1.shape)[0] != CIFAR_SPLITS[0]:
                raise AssertionError(f"crd banks {tuple(state.extra.v1.shape)}"
                                     f" not sized from the train split")
            log(f"[cifar_crd] banks {tuple(state.extra.v1.shape)} x 2 f32")
        log(f"[cifar_{method}] the loaded teacher equals the teacher run's "
            "best_acc.pt bit for bit")
        del state, result
    phase_zoo_sweep()
    log(f"[zoo] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return counts


# ------------------------------------------------------------- data axis
# phase_grad_accum: the MoCo main path and run_vanilla.sh's step at these
# --grad_accum values
ACCUM_MS = (1, 2, 4)
TEACHER_ACCUM_MS = (1, 2)
# the ranks' own processes: a hard limit, then every one is killed
RANK_TIMEOUT_S = 420
# the full-width runs of ranks sharing the card: 128 / 64 / 64 images, 2
# steps an epoch at batch 64 (each world's first step warms the card up)
RANK_SETS = (128, 64, 64)
# phase_two_ranks (b): one f32 step at 64^2, 4 rows a rank (TF32 off):
# losses, and every tensor of the state to 1e-3 of its scale
DP_RTOL = 1e-3
DP_SMALL = ["--distill", "moma", "--dataset", "prostate_hv", "--model_s",
            "effiB0", "--model_t", "effiB0", "--image_size", "64",
            "--batch_size", "8", "--nce_k", "64", "--feat_dim", "32",
            "--head", "mlp", "--mem", "MoCo", "--attn", "self", "-b", "1",
            "--fp32", "--epochs", "1", "--kl_teacher_bn", "train"]
DP_PERM = (5, 2, 7, 0, 3, 6, 1, 4)   # crosses the rank boundary


def phase_grad_accum():
    """--grad_accum M on the MoCo main path (M = 1, 2, 4; 4 steps each,
    every microbatch its own augment and its own KL, key and student
    forward) and on run_vanilla.sh's step (M = 1, 2; one augment a step):
    the launch counts, checked, the steady step time and the peak
    memory.  Returns the M = 2 MoCo run's launch counts."""
    from moma_tpu_torch.cli import train_teacher

    for m in ACCUM_MS:
        label = f"accum{m}"
        phase_main_path(MAIN_ARGS + ["--grad_accum", str(m), "--trial", label],
                        label, accum=m)
        r = MAIN_RUNS[label]
        # a steady step's launches: two steps' minus the first's (checked
        # over the run by phase_main_path)
        two, one = (expected_launches(r["state"], n, accum=m)[0]
                    for n in (2, 1))
        log(f"[grad_accum] MoCo M={m}: steady step {r['steady'] * 1e3:.1f} "
            f"ms, peak {r['peak'] / 2 ** 30:.2f} GiB; launches a steady step "
            + ", ".join(f"{k} {two[k] - one[k]}" for k in sorted(two)
                        if two[k] - one[k]))
        # its modules would stay on the card under later phases' peaks
        del r["state"]
    for m in TEACHER_ACCUM_MS:
        def expect(state, n, m=m):
            n_bn = _n_bn(state.model)
            return {"channel_sums": m * n_bn * n,
                    "grad_channel_sums": m * n_bn * n, "ra_layer": 2 * n,
                    "ra_layer_kernels": 4 * n, "flash_fwd": 0,
                    "k1_expand_stats": 0}

        phase_drive(train_teacher.main,
                    TEACHER_ARGS + ["--grad_accum", str(m), "--trial",
                                    f"accum{m}"],
                    f"teacher_accum{m}", lambda s: [s.model], expect=expect)
    return MAIN_RUNS["accum2"]["counts"]


def _run_group(cmd, timeout_s):
    """Run `cmd` in its own process group; on timeout kill the group (the
    launcher and every worker it started).  Returns (rc, stdout, stderr)."""
    import signal

    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise AssertionError(f"{cmd[:6]}... outlasted {timeout_s} s (killed): "
                             f"{out[-2000:]}\n{err[-2000:]}")
    return p.returncode, out, err


def _peak_reset(dev):
    import torch

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev):
    """Peak device memory since _peak_reset (0 for a CPU rehearsal)."""
    import torch

    if dev != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def rank_main(out_json, argv):
    """`chip_smoke.py --rank-main OUT ARGS... [--then ARGS...]` under
    torch.distributed.run: cli.train_student.main(ARGS) on this rank, for
    each ARGS in turn (one process group for all); rank 0 writes a list of
    each run's step times, run directory, peak memory, launch and
    collective counts (and a MoMA run's queue pointer) to OUT."""
    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.core.mesh import comm_counts, reset_comm_counts
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    runs, cur = [], []
    for a in argv:
        if a == "--then":
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    records = []
    for args in runs:
        dev = args[args.index("--device") + 1]
        _peak_reset(dev)
        reset_launch_counts()
        reset_comm_counts()
        state, result = train_student.main(args)
        records.append({"batch_times": result["train"]["batch_times"],
                        "run_dir": result["run_dir"],
                        "queue_ptr": getattr(getattr(state, "queue", None),
                                             "ptr", None),
                        "peak": _peak(dev), "launches": launch_counts(),
                        "comm": comm_counts()})
        del state, result
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out_json, "w") as f:
            json.dump(records, f)
    return 0


def phase_nccl_one_rank(runs=None):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1
    chip_smoke.py --rank-main ...` of cli.train_student, each of `runs`
    ((label, args, plain): by default MAIN_ARGS with --bn local, 4 steps,
    against the main path's run, then run_comparison.sh's crd line against
    phase_comparison's run; CMP_RUNS holds what each plain run gave) in one
    launcher: NCCL starts on the card and
    every collective of the steps runs through it (one rank: the results
    are copies); the per-step losses equal the run without a process
    group (`plain`) to STEP_LOSS_RTOL, the steady step beside the plain
    one, the launch counts a plain run's; rank 0 writes the
    checkpoints."""
    runs = runs or [
        ("moco", list(MAIN_ARGS) + ["--bn", "local"], CMP_RUNS["moco"]),
        ("crd", comparison_args("crd", "1", "1", "0.8", "--path_t",
                                CMP_RUNS["crd"]["teacher"]),
         CMP_RUNS["crd"])]
    out_json = os.path.join(SAVE_ROOT, "nccl1.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--rank-main",
           out_json]
    for i, (label, args, _) in enumerate(runs):
        cmd += (["--then"] if i else []) + list(args) + [
            "--save_dir", os.path.join(SAVE_ROOT, "nccl1_" + label)]
    t0 = time.perf_counter()
    rc, out, err = _run_group(cmd, RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"one-rank NCCL run exited {rc}:\n{out[-3000:]}"
                             f"\n{err[-3000:]}")
    with open(out_json) as f:
        records = json.load(f)
    for (label, args, plain), r in zip(runs, records):
        gap = _check_losses(_step_losses(r["run_dir"]), plain["losses"],
                            "nccl1 " + label)
        for tag in ("latest", "best_acc"):
            if not os.path.exists(os.path.join(r["run_dir"], "ckpt",
                                               f"{tag}.pt")):
                raise AssertionError(f"nccl1 {label}: rank 0 wrote no "
                                     f"{tag}.pt")
        n = len(r["batch_times"])
        if r["queue_ptr"] != plain.get("queue_ptr"):
            raise AssertionError(f"nccl1 {label}: queue_ptr "
                                 f"{r['queue_ptr']}")
        # the plain run's launch counts (steps checked equal above)
        want = plain["launches"] if "cuda" in args else {}
        for k, v in want.items():
            if r["launches"].get(k, 0) != v:
                raise AssertionError(f"nccl1 {label}: launch count {k}: "
                                     f"{r['launches'].get(k, 0)} != {v}")
        steady = statistics.median(r["batch_times"][1:])
        log(f"[nccl1] {label}: torch.distributed.run, 1 rank, NCCL"
            f"{', --bn local' if '--bn' in args else ''}: {n} steps; step "
            f"losses rel gap to the plain run {gap:.2e}; steady step "
            f"{steady * 1e3:.1f} ms vs {plain['steady'] * 1e3:.1f} ms "
            f"plain ({100 * (steady / plain['steady'] - 1):+.1f}%); peak "
            f"{r['peak'] / 2 ** 30:.2f} GiB; collectives over the run "
            f"{r['comm']}; checkpoints written by rank 0")
    log(f"[nccl1] {len(runs)} runs in one launcher: {wall:.1f} s (launcher "
        f"and start included)")


def _rank_probe(rank, world, dev="cuda"):
    """Which collectives gloo runs on `dev` tensors, and their values."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=dev)
    out = {}

    def gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts).tolist() == sum(
            ([float(r + 1)] * 4 for r in range(world)), [])

    def reduce(op, want):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y.tolist() == [want] * 4

    def ppermute():
        # the model axis's ring hop, to rank + 1 from rank - 1.  gloo's own
        # send / recv of a CUDA tensor is not probed: it writes the device
        # address as host memory and the process aborts ("writev ... Bad
        # address"), so a gloo group's hops go through pinned host buffers
        from moma_tpu_torch.core.mesh import create_mesh, model_axis

        create_mesh(world)
        y = model_axis().ppermute([x])[0]
        create_mesh(1)
        return (y.device == x.device
                and y.tolist() == [float((rank - 1) % world + 1)] * 4)

    for name, fn in (("all_gather", gather),
                     ("all_reduce_sum", lambda: reduce(
                         dist.ReduceOp.SUM, float(world * (world + 1) // 2))),
                     ("all_reduce_max", lambda: reduce(
                         dist.ReduceOp.MAX, float(world))),
                     ("barrier", lambda: dist.barrier() or True),
                     ("ppermute", ppermute)):
        try:
            out[name] = "ok" if fn() else "wrong values"
        except Exception as e:  # reported by name, then the phase fails
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def _wrapped_comm(record):
    """_wrapped_steps that puts the collective counts of the second step
    into `record`."""
    from moma_tpu_torch.core.mesh import comm_counts, reset_comm_counts

    def before(state, n):
        if n == 2:
            reset_comm_counts()

    def after(state, n):
        if n == 2:
            record.update(comm_counts())
    return _wrapped_steps(before=before, after=after)


def _rank_runs(save_root, runs, extra=lambda state, result: {},
               sets=None):
    """cli.train_student for each (label, argv) of `runs` on this rank:
    step times, loss, validation accuracy, peak memory, launch counts,
    the second step's collectives, the train-mode BN count (student and
    aux modules), plus `extra(state, result)`; the synthetic sets cut to
    `sets` (RANK_SETS by default)."""
    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    _set_root(save_root)
    out = {}
    with _cut_sets(sets or RANK_SETS):
        for label, argv in runs:
            dev = argv[argv.index("--device") + 1]
            _peak_reset(dev)
            reset_launch_counts()
            comm = {}
            with _wrapped_comm(comm):
                state, result = train_student.main(
                    argv + ["--save_dir", save_root])
            out[label] = {
                "batch_times": result["train"]["batch_times"],
                "loss": result["train"]["loss"],
                "val_acc": result["val"]["acc"], "peak": _peak(dev),
                "launches": launch_counts(), "comm_step": comm,
                "n_bn": _n_bn(state.student, *(
                    [state.aux] if hasattr(state, "aux") else [])),
                **extra(state, result)}
            del state, result
    return out


def _rank_full_width(rank, world, save_root, args):
    """cli.train_student with `args` (MAIN_ARGS) on this rank's half of
    each global batch, --bn local then --bn sync (_rank_runs, and the
    queue pointer)."""
    return _rank_runs(
        save_root, [(bn, args + ["--bn", bn, "--trial", f"dp2_{bn}"])
                    for bn in ("local", "sync")],
        lambda state, result: {"queue_ptr": state.queue.ptr})


def _small_batch_dp():
    import numpy as np

    rs = np.random.RandomState(0)
    return {"image": rs.randint(0, 256, (8, 64, 64, 3), dtype=np.uint8),
            "label": rs.randint(0, 4, (8,)).astype(np.int32),
            "shuffle_perm": np.array(DP_PERM, np.int64)}


def _dp_step(bn, accum, augment, dev="cuda", attn="self", mem="MoCo",
             mp=1):
    """One MoMA step of DP_SMALL (with --attn `attn`, --mem `mem`,
    --model_parallel `mp`: the grid made here) on `dev` from build_state's
    seeded weights: this data rank's rows of the batch (its share of each
    microbatch under --grad_accum); returns (metrics, the state's tensors
    on the CPU, the bank whole)."""
    import torch

    from moma_tpu_torch.core.config import parse_student_args
    from moma_tpu_torch.core.mesh import create_mesh, data_axis, rank_rows
    from moma_tpu_torch.train.loop import to_device
    from moma_tpu_torch.train.moma import (build_state, full_state,
                                           make_moma_train_step)
    from moma_tpu_torch.train.teacher import augment_fns

    cfg = parse_student_args(
        with_flags(DP_SMALL, attn=attn, mem=mem)
        + ["--bn", bn, "--grad_accum", str(accum), "--device", dev,
           "--model_parallel", str(mp)])
    create_mesh(mp)
    ax = data_axis()
    dev = torch.device(dev)
    state = build_state(cfg, dev, 4, seed=0)
    step = make_moma_train_step(cfg, augment_fns(cfg)[0] if augment else None,
                                kl_train_bn_override=True)
    batch = _small_batch_dp()
    rows = {k: (v if k == "shuffle_perm"
                else rank_rows(v, ax.rank, ax.world, accum))
            for k, v in batch.items()}
    state, m = step(state, to_device(rows, dev),
                    torch.Generator().manual_seed(5))
    full = full_state(state)
    cpu = {g: {k: v.detach().cpu() for k, v in full[g].items()}
           for g in ("student", "teacher", "heads")}
    cpu["queue"] = {k: v.cpu() for k, v in full["queue"]["memory"].items()}
    return {k: float(v) for k, v in m.items()}, cpu


def _rank_small(rank, world, dev="cuda"):
    """The three modes' 2-rank steps of DP_SMALL: 'local' with the
    augmentation (each rank its own stream); 'sync' without attention
    modules (whose batch-token attention mixes a rank's rows there and the
    global batch's under 'global': a difference by design); 'global'."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"local": _dp_step("local", 1, True, dev),
            "sync": _dp_step("sync", 1, False, dev, "none"),
            "global": _dp_step("global", 1, False, dev)}


def _rank_dp2(rank, world, save_root, args, dev):
    """phase_two_ranks' one world: the collective probe, the full-width
    runs, then the 64^2 oracles."""
    return {"probe": _rank_probe(rank, world, dev),
            "full": _rank_full_width(rank, world, save_root, args),
            "small": _rank_small(rank, world, dev)}


def _dp_compare(got, want, label, exact=False):
    (mg, sg), (mw, sw) = got, want
    for k in ("loss", "loss_cls", "loss_div", "loss_kd"):
        a, b = mg[k], mw[k]
        if not abs(a - b) <= DP_RTOL * abs(b) + 1e-6:
            raise AssertionError(f"{label}: {k} {a} vs {b}")
    gap, where = _state_gap(sg, sw)
    if not gap <= DP_RTOL:
        raise AssertionError(f"{label}: state gap {gap:.2e} at {where}")
    log(f"[dp2] {label}: loss {mg['loss']:.6f} vs {mw['loss']:.6f}, "
        f"loss_kd {mg['loss_kd']:.6f} vs {mw['loss_kd']:.6f}; state max rel "
        f"gap {gap:.2e}{' at ' + where if where else ''}")


def phase_two_ranks(dev="cuda", args=MAIN_ARGS):
    """Two ranks sharing the card, each its own spawned process in a gloo
    group (NCCL refuses two ranks on one device): which collectives gloo
    takes on CUDA tensors (the phase fails naming any it refuses); (a)
    MAIN_ARGS through cli.train_student, 32 rows a rank, --bn local and
    --bn sync: each rank's step times and peak memory, launch counts, and
    the bytes gathered and reduced in a step; (b) DP_SMALL's f32 step at
    64^2, 4 rows a rank: the 2-rank 'local' step (augmented) against
    --grad_accum 2 in this process, and the 2-rank 'sync' (--attn none)
    and 'global' steps against the one-process 'global' step, to
    DP_RTOL.  Two ranks on
    one card give no data-parallel speed: (a)'s times are those of two
    processes taking turns on one device.  Returns rank 0's 'local' launch
    counts."""
    import torch

    from moma_tpu_torch.core.mesh import spawn_ranks

    t_phase = time.perf_counter()
    save = os.path.join(SAVE_ROOT, "dp2")
    world = spawn_ranks(_rank_dp2, 2, (save, list(args), dev),
                        backend="gloo", timeout_s=RANK_TIMEOUT_S)
    probe = [w["probe"] for w in world]
    log(f"[dp2] gloo on {dev} tensors, 2 ranks on one device: {probe[0]}")
    refused = sorted({k for p in probe for k, v in p.items() if v != "ok"})
    if refused:
        raise AssertionError(f"gloo refuses on {dev} tensors: {refused}: "
                             f"{probe}")
    ranks = [w["full"] for w in world]
    small = [w["small"] for w in world]
    B = int(args[args.index("--batch_size") + 1])
    K = int(args[args.index("--nce_k") + 1])
    for bn in ("local", "sync"):
        a, b = ranks[0][bn], ranks[1][bn]
        if not (a["loss"] == b["loss"] and a["queue_ptr"] == b["queue_ptr"]
                and math.isfinite(a["loss"])):
            raise AssertionError(f"dp2 {bn}: ranks disagree or diverge: "
                                 f"{a['loss']} / {b['loss']}")
        if a["queue_ptr"] != (B * len(a["batch_times"])) % K:
            raise AssertionError(f"dp2 {bn}: queue_ptr {a['queue_ptr']}")
        n, n_bn = len(a["batch_times"]), a["n_bn"]
        want = ({"channel_sums": n_bn * n + n_bn * (2 * n - 1),
                 "grad_channel_sums": n_bn * n, "ra_layer": 2 * n}
                if dev == "cuda" else {})
        for r, res in enumerate((a, b)):
            for k, v in want.items():
                if res["launches"].get(k, 0) != v:
                    raise AssertionError(
                        f"dp2 {bn} rank {r}: launch count {k}: "
                        f"{res['launches'].get(k, 0)} != {v}")
            steady = statistics.median(res["batch_times"][1:])
            log(f"[dp2] {bn} rank {r}: {B // 2} rows of {B}, steady step "
                f"{steady * 1e3:.1f} ms, step times (s) "
                f"{[round(t, 4) for t in res['batch_times']]}, peak "
                f"{res['peak'] / 2 ** 30:.2f} GiB, launches "
                f"{res['launches']}")
        c = a["comm_step"]
        log(f"[dp2] {bn}: one step's collectives on a rank: "
            f"{c.get('all_gather', 0)} all_gather, "
            f"{c.get('all_gather_bytes', 0) / 1e6:.2f} MB sent in; "
            f"{c.get('all_reduce', 0)} all_reduce, "
            f"{c.get('all_reduce_bytes', 0) / 1e6:.2f} MB reduced; train "
            f"loss {a['loss']:.4f}, val acc {a['val_acc']:.2f}")

    # TF32 off for the f32 oracles, then back as it was: later phases
    # compare their runs with runs made before this one
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        accum = _dp_step("global", 2, True, dev=dev)
        one = _dp_step("global", 1, False, dev=dev)
        one_none = _dp_step("global", 1, False, dev=dev, attn="none")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for bn in ("local", "sync", "global"):
        gap, where = _state_gap(small[1][bn][1], small[0][bn][1])
        if small[0][bn][0] != small[1][bn][0] or gap != 0.0:
            raise AssertionError(f"dp2 {bn}: ranks 0 and 1 differ ({gap:.2e}"
                                 f" at {where})")
    _dp_compare(small[0]["local"], accum,
                "2-rank 'local' (augmented) vs --grad_accum 2, 64^2 f32")
    _dp_compare(small[0]["sync"], one_none,
                "2-rank 'sync' vs one-process 'global', --attn none, 64^2 "
                "f32")
    _dp_compare(small[0]["global"], one,
                "2-rank 'global' vs one-process 'global', 64^2 f32")
    log(f"[dp2] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return ranks[0]["local"]["launches"]


# phase_model_axis: --model_parallel 2, ranks sharing the card over gloo
MA_MP = 2
# (b) the ring oracle: Nb = 2B rows alike on the ranks, the K=16384 bank
# split over 2 ranks, feat_dim 512, 4 heads; tolerances of the forward and
# of the gradients, of each tensor's scale (the flash kernels are float32-
# accurate; bf16 rounds each hop's output and every product's operands)
RING_SHAPE = (128, 16384, 512, 4)   # (Nb, K, C, H)
RING_RTOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 5e-2)}


def _rank_ma_full(rank, world, save_root, runs):
    """cli.train_student for each (label, args) of `runs` with
    --model_parallel 2 (data 1 x model 2): _rank_runs, the step losses,
    the queue pointer and this rank's bank rows."""

    def extra(state, result):
        return {"losses": _step_losses(result["run_dir"]),
                "queue_ptr": state.queue.ptr,
                "bank_rows": state.queue.memory[
                    next(iter(state.queue.memory))].shape[0]}
    return _rank_runs(
        save_root, [(label, args + ["--model_parallel", str(MA_MP),
                                    "--trial", f"mp_{label}"])
                    for label, args in runs], extra)


def _rank_ma_row(rank, world, save_root, runs, dev, ring_shape, tp_runs):
    """phase_model_axis' (1 x 2) world: the full-width runs, the grid's
    oracles, then phase_teacher_parallel's runs and forwards (`tp_runs`;
    one world for both phases)."""
    return {"full": _rank_ma_full(rank, world, save_root, runs),
            "grid": _rank_ma_small(rank, world, dev, ring_shape),
            "tp": _rank_tp(rank, world, save_root, tp_runs, dev)}


def _ring_inputs(dtype, dev, shape):
    import torch

    g = torch.Generator().manual_seed(11)
    n, C = shape[0] + shape[1], shape[2]

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)
    return {"x": r(n, C), "kern": [r(C, 3 * C, scale=C ** -0.5),
                                   r(3 * C, scale=0.02),
                                   r(C, C, scale=C ** -0.5), r(C, scale=0.02)],
            "w": r(n, C)}


def _ring_loss_grads(dtype, dev, ring, shape=RING_SHAPE):
    """The ring attention's (ring: this rank's rows, a 1 x 2 grid) or one
    process's batch_token_attention_big outputs at `shape` (Nb, K, C, H)
    and the gradients of sum(out * w) (the ring's out_loc through
    all_gather + _grad_div), on the CPU in float32; and the flash launches
    of the call."""
    import torch

    from moma_tpu_torch.core.mesh import model_axis
    from moma_tpu_torch.moma.queue import _grad_div
    from moma_tpu_torch.ops.flash_attention import batch_token_attention_big
    from moma_tpu_torch.ops.ring_attention import ring_batch_token_attention
    from moma_tpu_torch.runtime import launch_counts, reset_launch_counts

    nb, _, _, heads = shape
    inp = _ring_inputs(dtype, dev, shape)
    kern = [t.clone().requires_grad_(True) for t in inp["kern"]]
    w = inp["w"]
    reset_launch_counts()
    if ring:
        mx = model_axis()
        x_rep = inp["x"][:nb].clone().requires_grad_(True)
        x_loc = mx.shard_rows(inp["x"][nb:]).clone().requires_grad_(True)
        out_rep, out_loc = ring_batch_token_attention(
            x_rep, x_loc, *kern, heads, mx)
        full = mx.all_gather_grad(_grad_div(out_loc, mx), 0)
        loss = ((out_rep * w[:nb]).float().sum()
                + (full * w[nb:]).float().sum())
        loss.backward()
        outs = [out_rep, out_loc]
        grads = [x_rep.grad, x_loc.grad] + [t.grad for t in kern]
    else:
        x = inp["x"].clone().requires_grad_(True)
        out = batch_token_attention_big(x, *kern, heads)
        (out * w).float().sum().backward()
        outs = [out[:nb], out[nb:]]
        grads = [x.grad[:nb], x.grad[nb:]] + [t.grad for t in kern]
    torch.cuda.synchronize() if dev != "cpu" else None
    return ([o.detach().float().cpu() for o in outs],
            [g.detach().float().cpu() for g in grads], launch_counts())


def _rank_ma_small(rank, world, dev="cuda", ring_shape=RING_SHAPE):
    """The f32 oracles of a grid of `world` ranks at --model_parallel 2
    (TF32 off): MoCo (--attn self; 'sync' with --attn none) and MoCoAtt
    'all' under --bn local (augmented), sync and global; on 2 ranks also
    the ring at RING_* in both dtypes and, on a (2 x 1) grid, --bn global
    --grad_accum 2."""
    import torch

    from moma_tpu_torch.core.mesh import create_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"moco_local": _dp_step("local", 1, True, dev, mp=MA_MP),
           "moco_sync": _dp_step("sync", 1, False, dev, "none", mp=MA_MP),
           "moco_global": _dp_step("global", 1, False, dev, mp=MA_MP),
           "att_local": _dp_step("local", 1, True, dev, "all", "MoCoAtt",
                                 mp=MA_MP),
           "att_global": _dp_step("global", 1, False, dev, "all", "MoCoAtt",
                                  mp=MA_MP)}
    if world == 2:
        create_mesh(MA_MP)
        for dt in (torch.float32, torch.bfloat16):
            out[f"ring_{dt}"] = _ring_loss_grads(dt, dev, True, ring_shape)
        out["accum"] = _dp_step("global", 2, False, dev)
    create_mesh(1)
    return out


def _close_scaled(got, want, rtol, label):
    d = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not d <= rtol * scale:
        raise AssertionError(f"{label}: max |diff| {d:.3e} > {rtol} x scale "
                             f"{scale:.3e}")
    return d / max(scale, 1e-30)


def phase_model_axis(dev="cuda", runs=None, ring_shape=RING_SHAPE,
                     tp_runs=None):
    """--model_parallel 2: the negative bank split over two model ranks, the
    ranks sharing the card through gloo.  (a) MAIN_ARGS and MOCOATT_ARGS
    through cli.train_student on a (1 x 2) grid: each rank's steady step
    and peak memory, launch counts (MoCoAtt 'all': MA_MP each of flash_fwd,
    flash_dq and flash_dkv a step, the ring's hops; MoCo none), the bytes
    all-gathered, sent in ring hops and reduced in a step, losses (the two
    ranks' alike); (b) at 64^2 f32, TF32 off, on a (2 x 2) and a (1 x 2)
    grid, MoCo and MoCoAtt 'all' under --bn local / sync / global against
    the one-process steps (--grad_accum 2 for 'local', --attn none for
    'sync'), the bank whole, every rank's state bit for bit; the ring at
    (Nb 128, K 16384, C 512, H 4), float32 and bfloat16, on 2 ranks against
    one process's batch_token_attention_big, forward and every gradient,
    to RING_RTOL (`ring_shape`, RING_SHAPE by default); (c) 2 data ranks, --bn global --grad_accum 2, against the
    one-process --grad_accum 2 step.  Two ranks taking turns on one card
    give no model-parallel speed.  The same world then runs
    phase_teacher_parallel's work (`tp_runs`, TP_RUNS by default).
    Returns rank 0's MoCoAtt launch counts and each rank's
    phase_teacher_parallel results."""
    import torch

    from moma_tpu_torch.core.mesh import spawn_ranks

    t_phase = time.perf_counter()
    runs = runs or (("moco", list(MAIN_ARGS)), ("mocoatt", list(MOCOATT_ARGS)))
    save = os.path.join(SAVE_ROOT, "mp2")
    row = spawn_ranks(_rank_ma_row, MA_MP,
                      (save, runs, dev, ring_shape, tp_runs or TP_RUNS),
                      backend="gloo", timeout_s=RANK_TIMEOUT_S)
    full = [w["full"] for w in row]
    log("[mp2] two model ranks share one card: their step times are those "
        "of two processes taking turns, no model-parallel speed")
    for label, args in runs:
        a, b = full[0][label], full[1][label]
        B = int(args[args.index("--batch_size") + 1])
        K = int(args[args.index("--nce_k") + 1])
        n = len(a["batch_times"])
        if not (a["loss"] == b["loss"] and math.isfinite(a["loss"])):
            raise AssertionError(f"mp2 {label}: ranks disagree or diverge: "
                                 f"{a['loss']} / {b['loss']}")
        if a["queue_ptr"] != (B * n) % K or a["bank_rows"] != K // MA_MP:
            raise AssertionError(f"mp2 {label}: queue_ptr {a['queue_ptr']}, "
                                 f"{a['bank_rows']} bank rows a rank")
        n_bn = a["n_bn"]
        flash = MA_MP if "MoCoAtt" in args else 0
        want = ({"channel_sums": n_bn * n + n_bn * (2 * n - 1),
                 "grad_channel_sums": n_bn * n, "ra_layer": 2 * n,
                 "flash_fwd": flash * n, "flash_dq": flash * n,
                 "flash_dkv": flash * n} if dev == "cuda" else {})
        for r, res in enumerate((a, b)):
            for k, v in want.items():
                if res["launches"].get(k, 0) != v:
                    raise AssertionError(
                        f"mp2 {label} rank {r}: launch count {k}: "
                        f"{res['launches'].get(k, 0)} != {v}")
            steady = statistics.median(res["batch_times"][1:])
            log(f"[mp2] {label} rank {r}: {K // MA_MP} of {K} bank rows, "
                f"{B} rows a step, steady step {steady * 1e3:.1f} ms, step "
                f"times (s) {[round(t, 4) for t in res['batch_times']]}, "
                f"peak {res['peak'] / 2 ** 30:.2f} GiB, launches "
                f"{res['launches']}")
        c = a["comm_step"]
        log(f"[mp2] {label}: one step's collectives on a rank: "
            f"{c.get('model_all_gather', 0)} model all_gather, "
            f"{c.get('model_all_gather_bytes', 0) / 1e6:.2f} MB sent in; "
            f"{c.get('ppermute', 0)} ring hops, "
            f"{c.get('ppermute_bytes', 0) / 1e6:.2f} MB sent; "
            f"{c.get('model_all_reduce', 0) + c.get('all_reduce', 0)} "
            f"all_reduce, {(c.get('model_all_reduce_bytes', 0) + c.get('all_reduce_bytes', 0)) / 1e6:.2f}"
            f" MB reduced ({c}); step losses {a['losses']}, val acc "
            f"{a['val_acc']:.2f}")

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        grids = {2 * MA_MP: spawn_ranks(_rank_ma_small, 2 * MA_MP,
                                        (dev, ring_shape), backend="gloo",
                                        timeout_s=RANK_TIMEOUT_S),
                 MA_MP: [w["grid"] for w in row]}
        one = {"moco_local": _dp_step("global", 2, True, dev),
               "moco_sync": _dp_step("global", 1, False, dev, "none"),
               "moco_global": _dp_step("global", 1, False, dev),
               "att_local": _dp_step("global", 2, True, dev, "all",
                                     "MoCoAtt"),
               "att_global": _dp_step("global", 1, False, dev, "all",
                                      "MoCoAtt"),
               "moco_aug": _dp_step("global", 1, True, dev),
               "att_aug": _dp_step("global", 1, True, dev, "all", "MoCoAtt"),
               "accum": _dp_step("global", 2, False, dev)}
        ring_one = {dt: _ring_loss_grads(dt, dev, False, ring_shape)
                    for dt in (torch.float32, torch.bfloat16)}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    # on one data row (1 x 2) every --bn is the one-process global step
    one_row = {"moco_local": "moco_aug", "att_local": "att_aug"}
    for w, res in grids.items():
        grid = f"({w // MA_MP} x {MA_MP})"
        for case in res[0]:
            if case.startswith("ring") or case == "accum":
                continue  # held below
            for r in range(1, w):
                gap, where = _state_gap(res[r][case][1], res[0][case][1])
                if res[r][case][0] != res[0][case][0] or gap != 0.0:
                    raise AssertionError(f"mp2 {grid} {case}: ranks 0 and {r} "
                                         f"differ ({gap:.2e} at {where})")
            ref = one[case] if w > MA_MP else one[one_row.get(case, case)]
            _dp_compare(res[0][case], ref,
                        f"{grid} grid {case} vs one process, 64^2 f32")
    _dp_compare(grids[MA_MP][0]["accum"], one["accum"],
                "(2 x 1) grid --bn global --grad_accum 2 vs one process")
    r0, r1 = grids[MA_MP][0], grids[MA_MP][1]
    for dt, (w_outs, w_grads, w_launch) in ring_one.items():
        f_rtol, g_rtol = RING_RTOL[str(dt).split(".")[-1]]
        outs, grads, launches = r0[f"ring_{dt}"]
        outs1, grads1, _ = r1[f"ring_{dt}"]
        # the ranks' rows of the bank tokens, in model order
        got_o = [outs[0], torch.cat([outs[1], outs1[1]])]
        got_g = [grads[0], torch.cat([grads[1], grads1[1]])] + grads[2:]
        errs = [_close_scaled(g, w_, f_rtol, f"ring {dt} out{i}")
                for i, (g, w_) in enumerate(zip(got_o, w_outs))]
        names = ("x_rep", "x_loc", "qkv_kernel", "qkv_bias", "proj_kernel",
                 "proj_bias")
        errs += [_close_scaled(g, w_, g_rtol, f"ring {dt} d{n}")
                 for n, g, w_ in zip(names, got_g, w_grads)]
        want = {"flash_fwd": MA_MP, "flash_dq": MA_MP,
                "flash_dkv": MA_MP} if dev == "cuda" else {}
        for k, v in want.items():
            if launches.get(k, 0) != v:
                raise AssertionError(f"ring {dt}: {k} {launches.get(k, 0)} "
                                     f"!= {v}")
        log(f"[mp2] ring {dt} (Nb {ring_shape[0]}, K {ring_shape[1]} over "
            f"{MA_MP} ranks, C {ring_shape[2]}, H {ring_shape[3]}) vs one "
            "process's "
            f"batch_token_attention_big: max rel gaps out {errs[:2]}, grads "
            f"{[f'{e:.2e}' for e in errs[2:]]} (rtol {f_rtol} / {g_rtol}); "
            f"launches a rank {launches} (one process: {w_launch})")
    log(f"[mp2] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return (full[0]["mocoatt"]["launches"] if "mocoatt" in full[0] else {},
            [w["tp"] for w in row])


# phase_teacher_parallel: config #5 at --model_parallel 2, each route of the
# fixed ViT teacher (and MoCoAtt 'all', whose ring runs the flash kernels),
# and the same-arch MoCo path with --grad_accum 2 over the split bank; 4
# steps of batch 64 each
TP_MP = 2
TP_SETS = (256, 64, 64)
TP_RUNS = (
    ("tensor", CROSS_ARGS),
    ("tensor_sp", CROSS_ARGS + ["--sequence_parallel"]),
    # --pp_microbatch's default at MP 2: 2 microbatches
    ("pipeline", CROSS_ARGS + ["--teacher_parallel", "pipeline"]),
    ("tensor_mocoatt", with_flags(CROSS_ARGS, mem="MoCoAtt", attn="all")),
    ("moco_accum2", MAIN_ARGS + ["--grad_accum", "2"]),
    # [5b-teachers] (d): the MoE teacher's 8 experts, 4 a rank
    ("expert", MOE_ARGS + ["--teacher_parallel", "expert"]),
)
# the big teacher of moma_tpu/models/vit_tp.py's docstring: ViT-B/16 at
# 384^2 (12 heads, 577 tokens), batch 64, seeded weights; each route's
# forward against the dense one, of max|ref| (float32 with TF32 off: the
# routes differ from the dense forward by summation order only; bf16 rounds
# each partial sum before its reduction)
BIG_VIT, BIG_IMAGE = "vit_base_patch16_384", 384
BIG_BATCH = 64
BIG_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
BIG_ROUTES = (("tp", 0), ("sp", 0), ("pp", 0))


def _rank_big_vit(rank, world, dev="cuda"):
    """BIG_VIT's tensor-, sequence- and pipeline-parallel forwards on this
    model rank, float32 (TF32 off) and bf16: the outputs (rank 0 also the
    dense forward's), the forward's time, the block bytes this rank holds
    and the forward's collectives."""
    import torch

    from moma_tpu_torch.core.mesh import (comm_counts, create_mesh,
                                          data_axis, model_axis,
                                          reset_comm_counts)
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.models.vit_pp import PPVisionTransformer
    from moma_tpu_torch.models.vit_tp import TPVisionTransformer

    create_mesh(world)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        g = torch.Generator().manual_seed(3)
        x = (torch.rand(BIG_BATCH, BIG_IMAGE, BIG_IMAGE, 3, generator=g) * 4
             - 2).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]

            def dense():
                return create_model(
                    BIG_VIT, 1000, dtype if dtype != torch.float32 else None,
                    generator=torch.Generator().manual_seed(0),
                    image_size=BIG_IMAGE).to(dev).eval()

            def timed(model, together=True):
                """The outputs, time and collectives of one forward (the
                first of its shapes: the routes' times are gloo's), the
                ranks starting `together`."""
                with torch.no_grad():
                    sync(dev)
                    if together:
                        torch.distributed.barrier()
                    reset_comm_counts()
                    t0 = time.perf_counter()
                    (grid, cls), logits = model(x)
                    sync(dev)
                return ((grid, cls, logits), time.perf_counter() - t0,
                        comm_counts())

            if rank == 0:
                outs, ms, _ = timed(dense(), together=False)
                out[(name, "dense")] = {
                    "outs": [o.float().cpu() for o in outs], "s": ms}
            for route, n_micro in BIG_ROUTES:
                model = dense()
                if route == "pp":
                    model = PPVisionTransformer(model, model_axis(), n_micro,
                                                data_axis().world)
                else:
                    model = TPVisionTransformer(model, model_axis(),
                                                route == "sp")
                _peak_reset(dev)
                outs, ms, comm = timed(model)
                out[(name, route)] = {
                    "outs": [o.float().cpu() for o in outs] if rank == 0
                    else None, "s": ms, "bytes": model.block_bytes(),
                    "comm": comm, "peak": _peak(dev)}
                del model
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        create_mesh(1)
    return out


MOE_BATCH = 64
MOE_RTOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rank_big_moe(rank, world, dev="cuda"):
    """The MoE ViT-S/16 teacher's expert-parallel forward on this model
    rank against its dense forward, batch MOE_BATCH at 224^2, float32
    (TF32 off) and bf16: the dense forward's expert choices are replayed
    in the expert-parallel one (a choice within rounding of a tie may flip
    between the two programs; `flips` counts those).  The outputs (rank
    0's), both forwards' times, the expert bytes this rank holds and the
    forward's collectives."""
    import copy

    import torch

    from moma_tpu_torch.core.mesh import (comm_counts, create_mesh,
                                          model_axis, reset_comm_counts)
    from moma_tpu_torch.models import create_model
    from moma_tpu_torch.models.vit_moe import EPMoEVisionTransformer

    create_mesh(world)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        x = (torch.rand(MOE_BATCH, 224, 224, 3,
                        generator=torch.Generator().manual_seed(3)) * 4
             - 2).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            dense = create_model(
                MOE_T, 1000, dtype if dtype != torch.float32 else None,
                generator=torch.Generator().manual_seed(0),
                image_size=224).to(dev).eval()
            ep = EPMoEVisionTransformer(copy.deepcopy(dense), model_axis())
            res = {}
            for label, model, routes in (("dense", dense, _moe_routes()),
                                         ("ep", ep, None)):
                if routes is None:
                    routes = _moe_routes(replay=res["dense"]["choices"])
                with torch.no_grad(), routes:
                    model(x)   # the first call of its shapes
                    sync(dev)
                    torch.distributed.barrier()
                    reset_comm_counts()
                    t0 = time.perf_counter()
                    (grid, cls), logits = model(x)
                    sync(dev)
                res[label] = {
                    "outs": [o.float().cpu() for o in (grid, cls, logits)]
                    if rank == 0 else None,
                    "s": time.perf_counter() - t0, "comm": comm_counts(),
                    "choices": routes.choices[len(routes.choices) // 2:],
                    "flips": routes.flips}
            res["ep"]["bytes"] = ep.expert_bytes()
            res["ep"]["experts"] = [m.w1.shape[0] for m in ep.moe_layers()]
            for r in res.values():
                del r["choices"]
            out[name] = res
            del dense, ep
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        create_mesh(1)
    return out


def _rank_tp(rank, world, save_root, runs, dev):
    """phase_teacher_parallel's work in phase_model_axis' (1 x 2) world:
    the CLI runs at --model_parallel 2, then BIG_VIT's forwards and the
    MoE teacher's."""

    def extra(state, result):
        t = state.teacher
        return {"losses": _step_losses(result["run_dir"]),
                "queue_ptr": state.queue.ptr,
                "bank_rows": state.queue.memory[
                    next(iter(state.queue.memory))].shape[0],
                "teacher_bytes": (t.block_bytes() if hasattr(
                    t, "block_bytes") else None),
                "expert_bytes": (t.expert_bytes() if hasattr(
                    t, "expert_bytes") else None),
                "experts": ([m.w1.shape[0] for m in t.moe_layers()]
                            if hasattr(t, "moe_layers") else None),
                "teacher_class": type(t).__name__}
    full = _rank_runs(
        save_root, [(label, args + ["--model_parallel", str(TP_MP),
                                    "--trial", f"tp_{label}"])
                    for label, args in runs], extra, sets=TP_SETS)
    return {"full": full, "big": _rank_big_vit(rank, world, dev),
            "big_moe": _rank_big_moe(rank, world, dev)}


def phase_teacher_parallel(row, dev="cuda", runs=TP_RUNS):
    """[5b-accum] and [5b-teachers] (b, c) on two gloo ranks sharing the
    card, a (1 x 2) grid (`row`: each rank's _rank_tp results, which
    phase_model_axis' world ran): (a) config #5 (CROSS_ARGS) through
    cli.train_student at --model_parallel 2 with the tensor-parallel ViT-S
    teacher (6 heads -> 3 a rank, MLP 1536 -> 768), with
    --sequence_parallel, pipelined (2 microbatches), and with
    MoCoAtt 'all' (the ring's flash kernels), and the MoCo main path with
    --grad_accum 2 over the split bank: each rank's steady step, img/s,
    peak memory, the teacher's block bytes a rank, one step's collectives,
    the kernels launched (checked against the counts a step), losses (the
    ranks' alike); (b) BIG_VIT's TP, TP+SP and PP forwards against its
    dense forward, float32 (TF32 off) and bf16: the max error of max|ref|,
    the block bytes a rank, the forward time and its collectives.  Two
    ranks take turns on one card: no model-parallel speed-up is measured.
    Returns rank 0's MoCoAtt launch counts."""
    full = [w["full"] for w in row]
    log(f"[tp2] ({CARD}) two model ranks share one card through gloo: their "
        "step and forward times are those of two processes taking turns, "
        "no model-parallel speed-up")
    for label, args in runs:
        a, b = full[0][label], full[1][label]
        B = int(args[args.index("--batch_size") + 1])
        K = int(args[args.index("--nce_k") + 1])
        n = len(a["batch_times"])
        accum = (int(args[args.index("--grad_accum") + 1])
                 if "--grad_accum" in args else 1)
        cross = args[args.index("--model_t") + 1] != "effiB0"
        if not (a["loss"] == b["loss"] and math.isfinite(a["loss"])):
            raise AssertionError(f"tp2 {label}: ranks disagree or diverge: "
                                 f"{a['loss']} / {b['loss']}")
        if a["queue_ptr"] != (B * n) % K or a["bank_rows"] != K // TP_MP:
            raise AssertionError(f"tp2 {label}: queue_ptr {a['queue_ptr']}, "
                                 f"{a['bank_rows']} bank rows a rank")
        want_class = {"pipeline": "PPVisionTransformer",
                      "expert": "EPMoEVisionTransformer"}.get(
            args[args.index("--teacher_parallel") + 1]
            if "--teacher_parallel" in args else "tensor",
            "TPVisionTransformer")
        if a["experts"] is not None and a["experts"] != [4] * 6:
            raise AssertionError(f"tp2 {label}: experts a rank "
                                 f"{a['experts']}, not 4 of 8 in 6 blocks")
        if cross != (a["teacher_class"] == want_class):
            raise AssertionError(f"tp2 {label}: teacher {a['teacher_class']}"
                                 f" (cross-arch: {cross})")
        n_bn = a["n_bn"]
        flash = TP_MP if "MoCoAtt" in args else 0
        # cross-arch: the student's and the EMA copy's train-mode forwards
        # a step; same-arch 'exact': the key forward a step and the KL
        # forward from the second step on, per microbatch
        teacher_train = n if cross else 2 * n - 1
        want = ({"channel_sums": accum * (n_bn * n + n_bn * teacher_train),
                 "grad_channel_sums": accum * n_bn * n,
                 "ra_layer": accum * 2 * n, "flash_fwd": flash * n,
                 "flash_dq": flash * n, "flash_dkv": flash * n}
                if dev == "cuda" else {})
        for r, res in enumerate((a, b)):
            for k, v in want.items():
                if res["launches"].get(k, 0) != v:
                    raise AssertionError(
                        f"tp2 {label} rank {r}: launch count {k}: "
                        f"{res['launches'].get(k, 0)} != {v}")
            steady = statistics.median(res["batch_times"][1:])
            tb = res["teacher_bytes"]
            log(f"[tp2] ({CARD}) {label} rank {r}: steady step "
                f"{steady * 1e3:.1f} ms = {B / steady:.1f} img/s, step times "
                f"(s) {[round(t, 4) for t in res['batch_times']]}, peak "
                f"{res['peak'] / 2 ** 30:.2f} GiB, teacher "
                f"{res['teacher_class']}"
                + (f" holding {tb[0] / 1e6:.2f} of {tb[1] / 1e6:.2f} MB of "
                   "block weights" if tb else "")
                + (f", {res['experts']} experts a MoE block, "
                   f"{res['expert_bytes'][0] / 1e6:.2f} of "
                   f"{res['expert_bytes'][1] / 1e6:.2f} MB of expert weights"
                   if res["experts"] else "")
                + f"; launches in {n} steps {res['launches']} (a step: "
                f"{ {k: v / n for k, v in res['launches'].items()} })")
        c = a["comm_step"]
        kinds = sorted({k[:-6] for k in c if k.endswith("_bytes")})
        log(f"[tp2] ({CARD}) {label}: step 2's collectives on a rank: "
            + ", ".join(f"{c[k]} {k} {c[k + '_bytes'] / 1e6:.2f} MB"
                        for k in kinds)
            + f"; step losses {a['losses']}, val acc {a['val_acc']:.2f}")

    big = row[0]["big"]
    for dtype in ("float32", "bfloat16"):
        ref = big[(dtype, "dense")]
        log(f"[tp2] ({CARD}) {BIG_VIT} batch {BIG_BATCH} {dtype} dense "
            f"forward {ref['s'] * 1e3:.1f} ms on one rank")
        for route, _ in BIG_ROUTES:
            res = big[(dtype, route)]
            gaps = [float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(res["outs"], ref["outs"])]
            if not max(gaps) <= BIG_RTOL[dtype]:
                raise AssertionError(f"{BIG_VIT} {dtype} {route}: max error "
                                     f"{max(gaps):.2e} of max|ref| > "
                                     f"{BIG_RTOL[dtype]}")
            c = res["comm"]
            kinds = sorted({k[:-6] for k in c if k.endswith("_bytes")})
            log(f"[tp2] ({CARD}) {BIG_VIT} {dtype} {route}: max error of "
                f"max|ref| (grid, cls, logits) "
                f"{[f'{e:.2e}' for e in gaps]} (limit {BIG_RTOL[dtype]}); "
                f"rank 0 holds {res['bytes'][0] / 1e6:.1f} of "
                f"{res['bytes'][1] / 1e6:.1f} MB of block weights, rank 1 "
                f"{row[1]['big'][(dtype, route)]['bytes'][0] / 1e6:.1f}; "
                f"forward {res['s'] * 1e3:.1f} ms (rank 1 "
                f"{row[1]['big'][(dtype, route)]['s'] * 1e3:.1f} ms), peak "
                f"{res['peak'] / 2 ** 30:.2f} GiB; a forward's collectives "
                + ", ".join(f"{c[k]} {k} {c[k + '_bytes'] / 1e6:.1f} MB"
                            for k in kinds))
    for dtype in ("float32", "bfloat16"):
        r0, r1 = row[0]["big_moe"][dtype], row[1]["big_moe"][dtype]
        ref, got = r0["dense"], r0["ep"]
        gaps = [float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(got["outs"], ref["outs"])]
        if not max(gaps) <= MOE_RTOL[dtype]:
            raise AssertionError(f"{MOE_T} {dtype} expert-parallel: max "
                                 f"error {max(gaps):.2e} of max|ref| > "
                                 f"{MOE_RTOL[dtype]}")
        c = got["comm"]
        kinds = sorted({k[:-6] for k in c if k.endswith("_bytes")})
        log(f"[tp2] ({CARD}) {MOE_T} batch {MOE_BATCH} {dtype} "
            f"expert-parallel forward vs dense: max error of max|ref| (grid,"
            f" cls, logits) {[f'{e:.2e}' for e in gaps]} (limit "
            f"{MOE_RTOL[dtype]}); expert choices that differed from the "
            f"dense forward's (replayed) {got['flips']} / {r1['ep']['flips']}"
            f" (ranks 0 / 1); experts a rank {got['experts']}, "
            f"{got['bytes'][0] / 1e6:.1f} of {got['bytes'][1] / 1e6:.1f} MB "
            f"of expert weights; forward {got['s'] * 1e3:.1f} / "
            f"{r1['ep']['s'] * 1e3:.1f} ms (ranks 0 / 1), dense "
            f"{ref['s'] * 1e3:.1f} ms on one rank; a forward's collectives "
            + ", ".join(f"{c[k]} {k} {c[k + '_bytes'] / 1e6:.2f} MB"
                        for k in kinds))
    return full[0].get("tensor_mocoatt", {}).get("launches", {})


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    t0 = time.perf_counter()
    name_power = phase_device()
    global CARD
    CARD = name_power
    top = tempfile.mkdtemp(prefix="chip_smoke_")
    _set_root(top)
    try:
        return _run(name_power, t0)
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _run(name_power, t0) -> int:
    import torch

    phase_build()
    results = {}
    phase_bn_kernels(results)
    phase_bn_forward()
    phase_bn_forward(image=224)
    phase_ra_kernel(results)
    phase_ra_kernel({}, shape=RA_SHAPE_224)
    phase_augment_launches()
    phase_flash_kernels(results)
    phase_fe_kernels(results)
    phase_fe_forward()
    phase_step_parity()
    phase_step_parity("MoCoAtt", "all", "2048")
    phase_step_parity(extra=("--fused_teacher", "on"))
    phase_step_parity(extra=("--model_t", "vit_small_patch16_224"))
    counts = phase_main_path()
    main = MAIN_RUNS["main"]
    # what phase_nccl_one_rank's MoCo run is held to (phase_packed frees
    # the main run's state)
    CMP_RUNS["moco"] = {
        "losses": main["losses"], "steady": main["steady"],
        "queue_ptr": main["state"].queue.ptr,
        "launches": expected_launches(main["state"], len(main["losses"]))[0]}
    accum_counts = phase_grad_accum()
    dp_counts = phase_two_ranks()
    mp_counts, tp_row = phase_model_axis()
    tp_counts = phase_teacher_parallel(tp_row)
    att_counts = phase_main_path(MOCOATT_ARGS, "mocoatt", flash_per_step=1)
    fused_counts = phase_main_path(FUSED_ARGS, "fused_teacher", fused=True)
    packed_counts = phase_packed()
    phase_persistence()
    cross_counts = phase_cross_arch()
    moe_counts = phase_moe()
    teacher_best, teacher_counts = phase_teacher()
    cmp_counts = phase_comparison(teacher_best)
    cmp2_counts = phase_comparison_ranks(teacher_best)
    phase_nccl_one_rank()
    zoo_counts = phase_zoo(results)
    # a kernel's launches: those of the first main path that runs it
    for later in (accum_counts, dp_counts, att_counts, fused_counts,
                  packed_counts, cross_counts, moe_counts, teacher_counts,
                  cmp_counts, cmp2_counts, zoo_counts, mp_counts, tp_counts):
        counts.update({k: v for k, v in later.items() if not counts.get(k)})
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                           "moma_tpu"))
    if leaked:
        raise AssertionError(f"imported JAX-side modules: {leaked[:5]}")
    kernels = [dict(name=k, route="cuda", launches=counts.get(k, 0), **v)
               for k, v in results.items()]
    log(f"[smoke] wall time {time.perf_counter() - t0:.1f} s (limit "
        f"{WATCHDOG_S} s)")
    print(json.dumps({"kernels": [
        {**{k: kk[k] for k in ("name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")},
         "library_share_ms": kk.get("library_share_ms")}
        for kk in kernels]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
