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
at 224^2 in EmaTec mode (CROSS_ARGS).

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
                 each path), step time, img/s, peak memory
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
                 (memory_s and memory_t rows differ).  Every run writes
                 under a temporary --save_dir, removed at exit
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


def expected_launches(state, n, flash_per_step=0, fused=False):
    """The kernel launches of an epoch of n steps of the 'exact' schedule
    on the state's model (and the number of its student's BatchNorms)."""
    n_bn = sum(1 for m in state.student.modules()
               if type(m).__name__ == "FusedBatchNorm")
    # first batch: eval-BN KL forward ('exact'), so student + key forwards;
    # later batches add the train-BN KL forward: 2n - 1 train-mode teacher
    # forwards and 2n teacher forwards in all.  Cross-arch: the student and
    # the EMA copy's key forward a step, the fixed teacher in eval mode
    teacher_train = n if state.ema is not None else 2 * n - 1
    want = {"channel_sums": n_bn * n + n_bn * teacher_train,
            "grad_channel_sums": n_bn * n,
            "ra_layer": 2 * n, "ra_layer_kernels": 4 * n,
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


def phase_main_path(args=MAIN_ARGS, label="main", flash_per_step=0,
                    fused=False):
    """Drive the CLI with `args`; `flash_per_step` launches of each
    flash-attention kernel are expected per step (0 on the MoCo path, whose
    attentions see 64 tokens and stay dense); `fused`: both teacher forwards
    run the fused EfficientNet forward."""
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
    if n != 4:
        raise AssertionError(f"main path ran {n} steps, expected 4")
    if state.queue.ptr != (64 * n) % 16384:
        raise AssertionError(f"queue_ptr {state.queue.ptr} != {64 * n}")
    want, n_bn = expected_launches(state, n, flash_per_step, fused)
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
    cross-arch runs, the EMA copy."""
    worst, where = 0.0, ""
    if set(got) != set(want):
        raise AssertionError(f"state groups {sorted(got)} != {sorted(want)}")
    for group in [g for g in ("student", "teacher", "heads", "queue",
                              "optimizer", "ema") if g in want]:
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


def _round_trip(base, label, sets):
    """A straight 2-epoch run and 1 epoch + --resume to 2 epochs: the same
    step losses and the same final state (to STATE_RTOL)."""
    from moma_tpu_torch.cli import train_student
    from moma_tpu_torch.train.moma import full_state

    with _cut_sets(sets):
        root = SAVE_ROOT
        _set_root(os.path.join(root, label, "straight"))
        s_st, r_st = train_student.main(_args(base, 2))
        _set_root(os.path.join(root, label, "resumed"))
        _, r_1 = train_student.main(_args(base, 1))
        s_re, r_re = train_student.main(_args(base, 2, "--resume"))
        _set_root(root)
    loss_gap = _check_losses(_step_losses(r_re["run_dir"]),
                             _step_losses(r_st["run_dir"]), label)
    if (s_re.step, s_re.queue.ptr) != (s_st.step, s_st.queue.ptr):
        raise AssertionError(f"{label}: step / queue_ptr "
                             f"{(s_re.step, s_re.queue.ptr)} != "
                             f"{(s_st.step, s_st.queue.ptr)}")
    gap, where = _state_gap(full_state(s_re), full_state(s_st))
    if not gap <= STATE_RTOL:
        raise AssertionError(f"{label}: resumed vs straight state gap "
                             f"{gap:.2e} at {where}")
    return s_re, r_1, r_re, loss_gap, gap, where


class _cut_sets:
    """Cut the synthetic train / val / test sets to (n_train, n_val,
    n_test) images for the runs inside."""

    def __init__(self, sizes):
        self.sizes = sizes

    def __enter__(self):
        from moma_tpu_torch.data.pipeline import ArrayDataset
        from moma_tpu_torch.train import moma as moma_train

        self.full = full = moma_train.build_datasets
        sizes = self.sizes
        moma_train.build_datasets = lambda cfg, syn: tuple(
            ArrayDataset(ds.images[:n], ds.labels[:n])
            for ds, n in zip(full(cfg, syn), sizes))

    def __exit__(self, *exc):
        from moma_tpu_torch.train import moma as moma_train

        moma_train.build_datasets = self.full
        return False


class _wrapped_steps:
    """For the runs inside, make_moma_train_step's step programs call
    `before(state, n)` before and `after(state, n)` after their n-th step
    (counted over all of them)."""

    def __init__(self, before=None, after=None):
        self.before, self.after = before, after

    def __enter__(self):
        from moma_tpu_torch.train import moma as moma_train

        self.make = make = moma_train.make_moma_train_step
        before, after, done = self.before, self.after, [0]

        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def counted(state, *rest):
                done[0] += 1
                if before is not None:
                    before(state, done[0])
                out = step(state, *rest)
                if after is not None:
                    after(out[0], done[0])
                return out
            return counted

        moma_train.make_moma_train_step = wrapped

    def __exit__(self, *exc):
        from moma_tpu_torch.train import moma as moma_train

        moma_train.make_moma_train_step = self.make
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


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    t0 = time.perf_counter()
    name_power = phase_device()
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
    att_counts = phase_main_path(MOCOATT_ARGS, "mocoatt", flash_per_step=1)
    fused_counts = phase_main_path(FUSED_ARGS, "fused_teacher", fused=True)
    phase_persistence()
    cross_counts = phase_cross_arch()
    # a kernel's launches: those of the first main path that runs it
    for later in (att_counts, fused_counts, cross_counts):
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
    sys.exit(main())
