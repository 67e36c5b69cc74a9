"""CLI: export a trained checkpoint as a self-contained serving artifact.

Counterpart of moma_tpu/cli/export_model.py: the eval forward (normalize,
backbone, classifier; weights inside, batch symbolic) through
`core/export.py` into `<out>.pt2` + `<out>.json`, which
`core.export.ExportedClassifier` (and `cli/serve.py`) reload without the
model zoo.

    # the best checkpoint of a run (a teacher run's model, or a
    # distillation run's student):
    python -m moma_tpu_torch.cli.export_model --run ./save/teacher_x \\
        --model effiB0 --dataset prostate_hv --image_size 512 \\
        --out ./serve/teacher_x
    # a fresh init (smoke / shape check), on the CPU:
    python -m moma_tpu_torch.cli.export_model --model resnet8 \\
        --image_size 32 --n_cls 10 --out /tmp/m --device cpu --verify

Precision modes (PRECISION_MODES, one at a time): --bf16 bakes bf16
compute in; --int8 calibrates per-tensor activation scales (--calib_n
batches of 8 images from --calib_images, else uniform noise) and runs every
conv and trunk dense layer in int8 (core/quantize.py; the logits layer stays
fp); --int8_dynamic takes each batch's own activation scales; --int8_weights
stores the quantized layers' weights int8 with per-channel scales and no
float copy, dequantized at every call.  On the card the int8 layers run the
hand-written kernels of ops/int8_conv.py, which the artifact calls as
custom operators.

--device cuda (default) exports on the card and the artifact serves there;
--device cpu exports a CPU artifact.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from moma_tpu_torch.core.config import DATASET_NUM_CLASSES
from moma_tpu_torch.core.export import ExportedClassifier, export_classifier
from moma_tpu_torch.data import augment as aug
from moma_tpu_torch.models import create_model
from moma_tpu_torch.runtime import resolve_device

# mode name -> export flags (export_model.py:199-211)
PRECISION_MODES = {
    "f32": [],
    "bf16": ["--bf16"],
    "int8": ["--int8", "--calib_n", "2"],
    "int8_bf16": ["--int8", "--calib_n", "2", "--bf16"],
    "int8_dynamic": ["--int8_dynamic"],
    "w8": ["--int8_weights"],
    "w8_bf16": ["--int8_weights", "--bf16"],
}


def _forward(model, x):
    return model(x)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moma_tpu_torch export_model")
    p.add_argument("--run", type=str, default=None,
                   help="run dir containing ckpt/<tag>.pt; omit to export a "
                        "fresh init (smoke)")
    p.add_argument("--ckpt_tag", type=str, default="best_acc",
                   choices=["best_acc", "best_f1", "latest"])
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--dataset", type=str, default="cifar100")
    p.add_argument("--n_cls", type=int, default=0)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and check logits match the "
                        "live model on a random batch")
    p.add_argument("--bf16", action="store_true",
                   help="bake bf16 compute into the artifact (logits f32)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 of every conv and trunk dense "
                        "layer (per-tensor activation / per-channel weight "
                        "scales, int32 sums; calibrated on --calib_n "
                        "batches)")
    p.add_argument("--calib_n", type=int, default=4,
                   help="int8 calibration batches (of 8 images), from "
                        "--calib_images when given, else uniform noise")
    p.add_argument("--calib_images", type=str, default=None,
                   help="glob of image files to calibrate int8 activation "
                        "scales on; omitted = uniform-noise calibration")
    p.add_argument("--int8_dynamic", action="store_true",
                   help="int8 with each batch's own activation scales (no "
                        "calibration; one absmax pass per conv at serve "
                        "time)")
    p.add_argument("--int8_weights", action="store_true",
                   help="weights-only int8: quantized layers store int8 "
                        "weights and per-channel scales, dequantized at "
                        "every call; activations and sums untouched")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to export on and serve from (cuda | cpu)")
    return p


def _normalizer(dataset: str, image_size: int):
    """train/teacher.py's eval normalization: by the DATASET (cifar100,
    and synthetic at 32^2, take CIFAR statistics), not the image size."""
    if dataset == "cifar100" or (dataset == "synthetic" and image_size == 32):
        return aug.cifar_eval_normalize   # /255 for uint8

    def norm(x):   # x uint8: normalize divides by 255 itself
        return aug.normalize(x, aug.IMAGENET_MEAN, aug.IMAGENET_STD)
    return norm


def served_model(a, dev: torch.device):
    """(the model, the module the artifact serves, its normalize, n_cls)
    for parsed flags `a`: the model at --run's weights (or a fresh init) on
    `dev` in eval mode, and in the precision mode of the flags (the model
    itself for f32 / --bf16)."""
    n_cls = a.n_cls or DATASET_NUM_CLASSES.get(a.dataset, 100)
    model = create_model(a.model, n_cls,
                         dtype=torch.bfloat16 if a.bf16 else None,
                         generator=torch.Generator().manual_seed(0),
                         image_size=a.image_size)
    if a.run:
        from moma_tpu_torch.models.pretrained import load_pretrained

        load_pretrained(model, os.path.join(a.run, "ckpt",
                                            a.ckpt_tag + ".pt"), strict=True)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    norm = _normalizer(a.dataset, a.image_size)

    from moma_tpu_torch.core import quantize as Q

    served = model
    if a.int8_weights:
        sample = norm(torch.zeros((2, a.image_size, a.image_size, 3),
                                  dtype=torch.uint8, device=dev))
        served, n_layers = Q.weight_only_for_serving(
            _forward, model, sample, dense=True, n_cls=n_cls)
        print(f"int8 weights-only: {n_layers} conv/dense kernels stored "
              f"int8 (per-channel scales), dequantized at every call")
    elif a.int8_dynamic:
        served = Q.Quantized(model, Q.quantized_apply_dynamic(_forward))
        print("int8 dynamic: per-batch activation scales")
    elif a.int8:
        if a.calib_images:
            import glob as _glob

            from moma_tpu_torch.cli.serve import _decode_batch

            paths = sorted(_glob.glob(a.calib_images))
            if not paths:
                raise SystemExit(
                    f"--calib_images matched no files: {a.calib_images}")
            need = min(len(paths), a.calib_n * 8)
            calib = [norm(torch.from_numpy(_decode_batch(
                paths[i: i + 8], a.image_size)).to(dev))
                for i in range(0, need, 8)]
            src = f"{need} images from {a.calib_images}"
        else:
            rs = np.random.RandomState(1234)
            calib = [norm(torch.from_numpy(rs.randint(
                0, 256, (8, a.image_size, a.image_size, 3), np.uint8)).to(dev))
                for _ in range(a.calib_n)]
            src = f"{a.calib_n} uniform-noise batches"
        fwd, scales = Q.quantize_for_serving(_forward, model, calib,
                                             dense=True, n_cls=n_cls)
        served = Q.Quantized(model, fwd)
        print(f"int8 PTQ: {len(scales)} conv/dense layers calibrated "
              f"({src})")
    return model, served, norm, n_cls


def main(argv=None):
    a = build_parser().parse_args(argv)
    if sum((a.int8, a.int8_dynamic, a.int8_weights)) > 1:
        # conflicting quantization modes error rather than being silently
        # resolved (the --bn/--sync_bn convention, core/config.py)
        raise SystemExit("pick ONE of --int8 / --int8_dynamic / "
                         "--int8_weights: calibrated activations vs "
                         "per-batch in-graph scales vs weights-only")
    dev = resolve_device(a.device)
    _, served, norm, n_cls = served_model(a, dev)

    path = export_classifier(
        served, a.image_size, a.out, normalize=norm,
        meta={"model": a.model, "n_cls": n_cls, "dataset": a.dataset,
              "ckpt": a.run or "fresh-init", "tag": a.ckpt_tag,
              "quantized": ("int8_dynamic" if a.int8_dynamic
                            else "int8" if a.int8
                            else "int8_weights" if a.int8_weights
                            else None)},
        device=dev)
    size_mb = os.path.getsize(path) / 1e6
    print(f"exported {a.model} ({n_cls} classes, {a.image_size}px) -> "
          f"{path} ({size_mb:.1f} MB, symbolic batch, {dev})")

    if a.verify:
        clf = ExportedClassifier(path)
        rs = np.random.RandomState(0)
        x = rs.randint(0, 256, (3, a.image_size, a.image_size, 3), np.uint8)
        got = clf(x).cpu().numpy()
        # the live (quantized) model on the same uint8 batch
        with torch.no_grad():
            _, want = served(norm(torch.from_numpy(x).to(dev)))
        want = want.float().cpu().numpy()
        if a.int8 or a.int8_dynamic or a.int8_weights:
            # a round(x / s) tie can flip between two programs' roundings,
            # and one early flip reshuffles every later rounding: bound the
            # relative L2 (export_model.py:364-375)
            rel = float(np.linalg.norm(got - want)
                        / (np.linalg.norm(want) + 1e-12))
            assert rel < 0.05, f"int8 artifact rel L2 {rel:.4f} >= 0.05"
            print(f"verify: artifact within int8 noise of the live model "
                  f"(rel L2 {rel:.2e}, batch 3, logits {got.shape})")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            print(f"verify: reloaded artifact matches the live model "
                  f"(batch 3, logits {got.shape})")
    return path


if __name__ == "__main__":
    main()
