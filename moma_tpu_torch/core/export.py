"""Model export for serving: a `torch.export` program with a symbolic batch.

Counterpart of moma_tpu/core/export.py.  `export_classifier` traces the
eval forward `logits = model(normalize(uint8 NHWC images))` (normalize,
backbone, classifier; weights inside the program) with `torch.export`,
its batch dimension symbolic, so one artifact serves any batch size, and
`ExportedClassifier` reloads it without the model zoo: `torch.export.load`
and the port's int8 operators (ops/int8_conv.py registers them), which an
int8 artifact calls.

Format: `<path>.pt2` (torch.export.save) and `<path>.json`, the JAX
package's meta (image size, model, class count, ...) plus `device`, the
device the program was exported on and serves on: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from moma_tpu_torch.runtime import resolve_device


class _Predict(nn.Module):
    """images (B, H, W, 3) uint8 -> f32 logits of `model` in eval mode."""

    def __init__(self, model: nn.Module, normalize: Optional[Callable]):
        super().__init__()
        self.model = model
        self.normalize = normalize

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # the RAW uint8 goes to normalize, which divides by 255 only for
        # uint8 input (data/augment.py:37-45); casting it to float first
        # would skip the scaling and serve garbage logits
        x = (self.normalize(images) if self.normalize is not None
             else images.float())
        out = self.model(x)
        # backbones return (feats, logits)
        logits = out[1] if isinstance(out, tuple) else out
        return logits.float()


def _artifact(path: str) -> str:
    return path if path.endswith(".pt2") else path + ".pt2"


def export_classifier(model: nn.Module, image_size: int, path: str,
                      normalize: Optional[Callable] = None,
                      meta: Optional[dict] = None,
                      device: Union[str, torch.device] = "cuda") -> str:
    """Export `logits = model(normalize(uint8 images))` on `device` with a
    symbolic batch; returns the .pt2 path.  A model whose forward cannot
    take a symbolic batch raises, naming the model (meta's 'model')."""
    dev = resolve_device(device)
    pred = _Predict(model.to(dev).eval(), normalize).eval()
    example = torch.zeros((2, image_size, image_size, 3), dtype=torch.uint8,
                          device=dev)
    batch = torch.export.Dim("batch", min=1)
    name = (meta or {}).get("model", type(model).__name__)
    try:
        with torch.no_grad():
            program = torch.export.export(
                pred, (example,), dynamic_shapes=({0: batch},), strict=False)
    except Exception as e:
        raise RuntimeError(
            f"cannot export {name} with a symbolic batch: "
            f"{type(e).__name__}: {str(e).splitlines()[0]}") from e
    out = _artifact(path)
    os.makedirs(os.path.dirname(os.path.abspath(out)) or ".", exist_ok=True)
    torch.export.save(program, out)
    with open(out[: -len(".pt2")] + ".json", "w") as f:
        json.dump({"image_size": image_size, **(meta or {}),
                   "device": str(dev)}, f, indent=2)
    return out


def _copy_to(module: nn.Module, program, device: torch.device):
    """The program's module on `device` (a copy of the program's tensors
    there, and its graph's device arguments moved), or `module` itself when
    it already is there."""
    if device == _device_of(module):
        return module
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device).module()


def _device_of(module: nn.Module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return torch.device("cpu")


class ExportedClassifier:
    """A reloaded serving artifact: `logits = clf(uint8 images)` for any
    batch size, on the device it was exported on; no model zoo, no
    checkpoint code."""

    def __init__(self, path: str):
        # the int8 artifacts call the port's custom operators
        import moma_tpu_torch.ops.int8_conv  # noqa: F401

        art = _artifact(path)
        self._program = torch.export.load(art)
        self._module = self._program.module()
        self.device = _device_of(self._module)
        self.meta = {}
        meta_path = art[: -len(".pt2")] + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.meta = json.load(f)
        self._call = self._one

    def _one(self, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._module(images.to(self.device))

    def __call__(self, images) -> torch.Tensor:
        return self._call(torch.as_tensor(np.asarray(images, np.uint8)
                                          if not torch.is_tensor(images)
                                          else images).to(torch.uint8))

    def shard(self, devices: Optional[Sequence] = None):
        """Data-parallel serving over `devices` (default: every visible card
        of the artifact's device type, the one CPU on the CPU): one copy of
        the program a device, each batch split into equal row blocks, one a
        device, padded with copies of row 0 when the batch does not divide
        (rows are independent in eval mode) and sliced after; the logits
        come back on the first device.  Returns self for chaining."""
        if devices is None:
            devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else ["cpu"])
        devs = [resolve_device(d) for d in devices]
        copies = [_copy_to(self._module, self._program, d) for d in devs]
        n = len(devs)

        def dispatch(images: torch.Tensor) -> torch.Tensor:
            b = images.shape[0]
            pad = (-b) % n
            if pad:
                images = torch.cat([images, images[:1].expand(
                    pad, *images.shape[1:])])
            parts = images.chunk(n)
            with torch.no_grad():
                outs = [m(p.to(d, non_blocking=True))
                        for m, p, d in zip(copies, parts, devs)]
            logits = torch.cat([o.to(devs[0]) for o in outs])
            return logits[:b] if pad else logits

        self._call = dispatch
        return self

    def predict(self, images, batch_size: int = 0) -> np.ndarray:
        """Host-side convenience: optional micro-batching, then argmax."""
        images = np.asarray(images, np.uint8)
        if batch_size and images.shape[0] > batch_size:
            logits = np.concatenate([
                self(images[i: i + batch_size]).cpu().numpy()
                for i in range(0, images.shape[0], batch_size)], axis=0)
        else:
            logits = self(images).cpu().numpy()
        return logits.argmax(axis=-1)
