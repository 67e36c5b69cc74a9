"""Pretrained-weight bootstrapping for --std_pre / --tec_pre.

Counterpart of moma_tpu/models/pretrained.py (`resolve_pretrain` :40,
`load_pretrained_params` :122).  `load_pretrained(module, path, strict)`
replaces a backbone's weights in place from:

  * the port's own checkpoint (core/checkpoint.py, `<run>/ckpt/<tag>.pt`):
    its `student` entry, as the JAX package takes the student of a MoMA
    run's checkpoint (:158-163);
  * a torch state dict (.pth/.pt/.bin/.ckpt, optionally wrapped in
    {'model': ...} or {'state_dict': ...}: reference-trained weights, or
    the export of moma_tpu.cli.export_torch), converted through the port's
    models/torch_import.py (stream alignment by module kind, in call
    order) into the module.

Shapes merge strictly; `strict=False` keeps the module's own classifier
(the reference's cross-task transfer, --std_strict / --tec_strict).  An
orbax checkpoint directory of the JAX package is refused with the command
that exports it to a torch file: the port imports no orbax.

A ViT (models/vit.py) takes the port's own checkpoint like any backbone;
it has no BN statistics to restore (moma_tpu/cli/test_eval.py:212).  A
torch state-dict file for a ViT is refused, as in the JAX package: the
stream converter cannot align its cls token and position embedding.
Augreg .npz weights load through models/vit_npz.load_vit_npz.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from moma_tpu_torch.models.torch_import import (_torch_modules,
                                                convert_torch_checkpoint,
                                                export_state_dict)

# the reference resolves these tags through a table of absolute paths on
# its author's machines (model_def.py:15-49); the portable equivalent is a
# user-supplied registry
REFERENCE_PRESET_TAGS = frozenset({
    "tma_class", "PANDA", "gastric_wsi", "gastric_wsi_DDP",
    "gastric_cancer_tma_sv0", "kather19", "kather19_nonorm",
    "crc_tp_folder1_None", "crc_tp_folder1_Img", "ssl_ciga", "ImageNet",
})
_SCRATCH_TAGS = frozenset({"", "NULL", "None", "none", "scratch"})
_TORCH_SUFFIXES = (".pth", ".pt", ".bin", ".ckpt")


class PretrainResolutionError(KeyError):
    pass


def resolve_pretrain(spec: Optional[str]) -> Optional[str]:
    """Resolve a --std_pre / --tec_pre value to a checkpoint path.

    None / 'NULL' means from scratch; an existing path is used as it is;
    a tag resolves through $MOMA_PRETRAIN_REGISTRY (a JSON file mapping
    tag -> path, relative to the file), then $MOMA_PRETRAIN_DIR (default
    ./pretrained) as {dir}/{tag} or {dir}/{tag}.pth/.pt/.bin/.ckpt.  An
    unresolvable tag raises: skipping it would train another model than
    asked for."""
    if spec is None:
        return None
    spec = str(spec)
    if spec in _SCRATCH_TAGS:
        return None
    if os.path.exists(spec):
        return spec

    tried = []
    reg_path = os.environ.get("MOMA_PRETRAIN_REGISTRY")
    if reg_path and os.path.exists(reg_path):
        with open(reg_path) as f:
            table = json.load(f)
        if spec in table:
            p = table[spec]
            if not os.path.isabs(p):
                p = os.path.join(os.path.dirname(os.path.abspath(reg_path)), p)
            if os.path.exists(p):
                return p
            tried.append(f"registry entry {p} (missing)")
        else:
            tried.append(f"registry {reg_path} (no '{spec}' key)")
    pre_dir = os.environ.get("MOMA_PRETRAIN_DIR", "./pretrained")
    for cand in [os.path.join(pre_dir, spec)] + [
            os.path.join(pre_dir, spec + sfx) for sfx in _TORCH_SUFFIXES]:
        if os.path.exists(cand):
            return cand
        tried.append(cand)

    known = ("a tag the reference maps to a machine-specific absolute path "
             "(model_def.py:15-49)" if spec in REFERENCE_PRESET_TAGS
             else "not a reference preset tag")
    raise PretrainResolutionError(
        f"cannot resolve pretrain '{spec}' ({known}): not an existing path, "
        f"and no checkpoint found at: {', '.join(tried)}. Provide the file "
        f"via $MOMA_PRETRAIN_REGISTRY (JSON tag->path) or place it under "
        f"$MOMA_PRETRAIN_DIR as {spec}.pth (torch) or {spec}.pt (a "
        f"checkpoint of this package).")


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _flax_view(module: torch.nn.Module) -> Dict:
    """The module's weights as an insertion-ordered flax-layout tree
    ({'params', 'batch_stats'}; HWIO conv and (in, out) dense kernels),
    the template the torch-import alignment fills."""
    state = {k: v.detach().cpu().float().numpy()
             for k, v in module.state_dict().items()}
    params, stats = {}, {}
    for m in _torch_modules(state):
        path, g = tuple(m["prefix"].split(".")), m["tensors"]
        if m["kind"] == "bn":
            _set(params, path, {"scale": g["weight"], "bias": g["bias"]})
            _set(stats, path, {"mean": g["running_mean"],
                               "var": g["running_var"]})
        elif m["kind"] in ("conv", "linear"):
            w = g["weight"]
            leaf = {"kernel": (np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4
                               else np.transpose(w, (1, 0)))}
            if "bias" in g:
                leaf["bias"] = g["bias"]
            _set(params, path, leaf)
        elif m["kind"] == "ln":
            _set(params, path, {k2: v for k2, v in
                                (("scale", g["weight"]),
                                 ("bias", g.get("bias"))) if v is not None})
        else:
            raise ValueError(f"cannot map module {m['prefix']!r} "
                             f"({sorted(g)}) to a flax layout")
    return {"params": params, "batch_stats": stats}


def _load_port_state(module: torch.nn.Module, sd: Dict, strict: bool):
    if not strict:
        sd = {k: v for k, v in sd.items() if not k.startswith("classifier.")}
    res = module.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys
               if strict or not k.startswith("classifier.")]
    if missing or res.unexpected_keys:
        raise KeyError(f"checkpoint does not fit the module: missing "
                       f"{missing[:5]}, unexpected {res.unexpected_keys[:5]}")


def load_pretrained(module: torch.nn.Module, path: Optional[str],
                    strict: bool = True) -> torch.nn.Module:
    """Replace `module`'s parameters and BN statistics, in place, from the
    checkpoint at `path` (a path or a preset tag, see resolve_pretrain);
    returns the module.  Nothing happens for a from-scratch spec."""
    path = resolve_pretrain(path)
    if path is None:
        return module
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?): moma_tpu_torch reads no orbax. Export it to a torch "
            "file first with `python -m moma_tpu.cli.export_torch` and pass "
            "the .pth")
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = None  # a reference checkpoint with pickled objects
    if isinstance(obj, dict) and isinstance(obj.get("student"), dict):
        # a checkpoint of this package: the run's student
        _load_port_state(module, obj["student"], strict)
        return module
    from moma_tpu_torch.models.vit import VisionTransformer

    if isinstance(module, VisionTransformer):
        raise ValueError(
            f"{path}: a torch state dict cannot be aligned to a ViT (the "
            "stream converter has no slot for cls_token / pos_embed, in the "
            "JAX package too); pass a checkpoint of this package, or load "
            "augreg .npz weights with moma_tpu_torch.models.vit_npz."
            "load_vit_npz")
    loaded = convert_torch_checkpoint(path, _flax_view(module),
                                      drop_classifier=not strict)
    sd = export_state_dict(loaded, {k: v.detach().cpu().float().numpy()
                                    for k, v in module.state_dict().items()},
                           skip_classifier=not strict)
    own = module.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.as_tensor(np.asarray(v)))
    return module
