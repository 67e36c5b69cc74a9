"""PyTorch <-> Flax checkpoint conversion.

The port's own copy of moma_tpu/models/torch_import.py (numpy-only, same
names): moma_tpu_torch imports nothing of the JAX package, and
moma_tpu_torch.interop carries weights across with it.

Import: converts reference-trained .pth state dicts (incl. `module.` DDP
prefixes and torchvision/timm layouts) into this framework's NHWC Flax
pytrees.  Export (`export_state_dict`): the exact inverse — fills a torch
state-dict TEMPLATE with this framework's weights, so models trained here
load straight into the reference's torch tooling
(helper/util.py:141-162 `load_pretrained_weights` / test.py evaluation).

Strategy: stream alignment by module kind.  Both frameworks enumerate
modules of a given kind (conv / bn / linear / layernorm) in call order —
torch via state_dict insertion order, flax via natural-sorted DFS of the
auto-numbered scope tree (Conv_0, Conv_1, ..., Conv_10 sorted numerically,
not lexically).  Aligning the per-kind streams and transposing kernels
(OIHW -> HWIO, OI -> IO) reproduces the weights exactly; forward parity is
enforced by tests/test_torch_import.py (the JAX package's copy) and by the
tests/test_torch_port_* parity tests, which carry every weight through here.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _flax_modules(tree: Dict, bs_tree: Dict, prefix=()) -> List[dict]:
    """DFS over the flax params tree IN INSERTION ORDER — flax creates
    param subtrees in call order during init, so plain dict order
    reproduces the execution order (alphabetical sorting would put
    BasicBlock_0 before the stem Conv_0).  Requires `variables` straight
    from model.init, not round-tripped through tree_map (which sorts)."""
    out = []
    keys = list(tree.keys())
    for k in keys:
        v = tree[k]
        path = prefix + (k,)
        if isinstance(v, dict) and any(
            isinstance(x, dict) for x in v.values()
        ):
            out.extend(_flax_modules(v, bs_tree.get(k, {}) if isinstance(bs_tree, dict) else {}, path))
        elif isinstance(v, dict):
            leaves = set(v.keys())
            bs = bs_tree.get(k, {}) if isinstance(bs_tree, dict) else {}
            if leaves >= {"scale", "bias"} and {"mean", "var"} <= set(bs.keys()):
                kind = "bn"
            elif leaves >= {"scale", "bias"} or leaves == {"scale"}:
                kind = "ln"
            elif "kernel" in leaves and np.ndim(v["kernel"]) == 4:
                kind = "conv"
            elif "kernel" in leaves and np.ndim(v["kernel"]) == 2:
                kind = "linear"
            elif "embedding" in leaves:
                kind = "embed"
            else:
                kind = "param"
            out.append({"path": path, "kind": kind, "params": v, "bs": bs})
        else:
            out.append({"path": path, "kind": "raw", "params": {None: v}, "bs": {}})
    return out


def _torch_modules(state_dict: Dict[str, Any]) -> List[dict]:
    """Group a torch state dict by module prefix, classify by kind, keep
    insertion order.  Strips DDP 'module.' prefixes."""
    groups: Dict[str, dict] = {}
    order: List[str] = []
    for key, val in state_dict.items():
        name = key[len("module."):] if key.startswith("module.") else key
        if name.endswith("num_batches_tracked"):
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if prefix not in groups:
            groups[prefix] = {}
            order.append(prefix)
        groups[prefix][leaf] = np.asarray(val)
    out = []
    for prefix in order:
        g = groups[prefix]
        if "running_mean" in g:
            kind = "bn"
        elif "weight" in g and g["weight"].ndim == 4:
            kind = "conv"
        elif "weight" in g and g["weight"].ndim == 2:
            kind = "linear"
        elif "weight" in g and g["weight"].ndim == 1:
            kind = "ln"
        else:
            kind = "param"
        out.append({"prefix": prefix, "kind": kind, "tensors": g})
    return out


def _convert_module(kind: str, torch_mod: dict, flax_mod: dict):
    """Write torch tensors into the flax module's params/bs leaf shapes."""
    g = torch_mod["tensors"]
    p = dict(flax_mod["params"])
    bs = dict(flax_mod["bs"])
    if kind == "conv":
        w = g["weight"]  # (O, I/groups, kh, kw)
        kernel = np.transpose(w, (2, 3, 1, 0))  # HWIO (grouped convs match)
        _check(kernel.shape, np.shape(p["kernel"]), torch_mod, flax_mod)
        p["kernel"] = kernel
        if "bias" in g and "bias" in p:
            p["bias"] = g["bias"]
    elif kind == "linear":
        kernel = np.transpose(g["weight"], (1, 0))
        _check(kernel.shape, np.shape(p["kernel"]), torch_mod, flax_mod)
        p["kernel"] = kernel
        if "bias" in g and "bias" in p:
            p["bias"] = g["bias"]
    elif kind == "bn":
        _check(g["weight"].shape, np.shape(p["scale"]), torch_mod, flax_mod)
        p["scale"] = g["weight"]
        p["bias"] = g["bias"]
        bs["mean"] = g["running_mean"]
        bs["var"] = g["running_var"]
    elif kind == "ln":
        p["scale"] = g["weight"]
        if "bias" in g and "bias" in p:
            p["bias"] = g["bias"]
    else:
        raise ValueError(f"unhandled kind {kind} at {torch_mod['prefix']}")
    return p, bs


def _check(got, want, torch_mod, flax_mod):
    if tuple(got) != tuple(want):
        raise ValueError(
            f"shape mismatch: torch {torch_mod['prefix']} {tuple(got)} vs "
            f"flax {'/'.join(flax_mod['path'])} {tuple(want)}"
        )


def convert_state_dict(
    state_dict: Dict[str, Any], variables: Dict, drop_classifier: bool = False
) -> Dict:
    """Returns {'params':…, 'batch_stats':…} shaped like `variables` with
    weights from the torch state dict.

    drop_classifier=True is the cross-task transfer mode (the reference's
    strict=False load, helper/util.py:156-159 — which pops the hardcoded
    effiB0 'classifier_.1.*' keys; generalized here to every backbone):
    the flax 'classifier' module is excluded from the linear stream (it
    keeps its fresh init) and the torch side tolerates either a trailing
    classifier of any label width or an encoder-only dump with extra
    projection-head linears (e.g. the ssl_ciga checkpoint,
    model_def.py:66-76)."""
    def _copy(tree):
        # order-preserving deep copy (tree_map would sort dict keys and
        # destroy the call-order information _flax_modules relies on)
        if isinstance(tree, dict):
            return {k: _copy(v) for k, v in tree.items()}
        return np.asarray(tree)

    params = _copy(dict(variables["params"]))
    batch_stats = _copy(dict(variables.get("batch_stats", {})))
    flax_mods = _flax_modules(params, batch_stats)
    torch_mods = _torch_modules(state_dict)

    streams_f = {}
    for m in flax_mods:
        streams_f.setdefault(m["kind"], []).append(m)
    streams_t = {}
    for m in torch_mods:
        streams_t.setdefault(m["kind"], []).append(m)

    for kind in ("conv", "bn", "linear", "ln"):
        fs = streams_f.get(kind, [])
        ts = streams_t.get(kind, [])
        if drop_classifier and kind == "linear":
            fs = [m for m in fs if m["path"][0] != "classifier"]
            # the classifier is the LAST linear in call order in every
            # reference backbone; an encoder-only dump may instead carry
            # extra trailing projection-head linears — keep the prefix.
            if len(ts) < len(fs):
                raise ValueError(
                    "linear stream too short for the backbone even after "
                    f"dropping the classifier: flax {len(fs)} vs torch {len(ts)}"
                )
            ts = ts[: len(fs)]
        if len(fs) != len(ts):
            raise ValueError(
                f"{kind} stream length mismatch: flax {len(fs)} vs torch "
                f"{len(ts)} — architectures differ"
            )
        for fm, tm in zip(fs, ts):
            new_p, new_bs = _convert_module(kind, tm, fm)
            _set(params, fm["path"], new_p)
            if new_bs:
                _set(batch_stats, fm["path"], new_bs)
    return {"params": params, "batch_stats": batch_stats}


def _set(tree: Dict, path: Tuple[str, ...], value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_torch_checkpoint(
    path: str, variables: Dict, drop_classifier: bool = False
) -> Dict:
    """Load a .pth file (optionally a {'model': state_dict} training
    checkpoint, the reference's save format train_teacher.py:306-332, or a
    {'state_dict': …} wrapper like the ssl_ciga ozanciga checkpoint,
    model_def.py:66-76)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    state_dict = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in obj.items()}
    return convert_state_dict(state_dict, variables, drop_classifier=drop_classifier)


# ---------------------------------------------------------------------------
# Flax -> torch (the inverse direction)
# ---------------------------------------------------------------------------


def _export_module(kind: str, flax_mod: dict, torch_mod: dict) -> Dict[str, Any]:
    """Inverse of _convert_module: flax leaves -> torch tensor values,
    keyed by the torch leaf name (weight/bias/running_mean/running_var)."""
    p, bs, g = flax_mod["params"], flax_mod["bs"], torch_mod["tensors"]
    out: Dict[str, Any] = {}
    if kind in ("conv", "linear") and ("bias" in g) and ("bias" not in p):
        # silently keeping the template's (random-init) bias would export
        # a model that loads cleanly but computes garbage — refuse instead
        raise ValueError(
            f"torch {torch_mod['prefix']} expects a bias the flax module "
            f"{'/'.join(flax_mod['path'])} does not have")
    if kind == "conv":
        w = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))  # HWIO->OIHW
        _check(w.shape, g["weight"].shape, torch_mod, flax_mod)
        out["weight"] = w
        if "bias" in g and "bias" in p:
            out["bias"] = np.asarray(p["bias"])
    elif kind == "linear":
        w = np.transpose(np.asarray(p["kernel"]), (1, 0))  # (in,out)->(out,in)
        _check(w.shape, g["weight"].shape, torch_mod, flax_mod)
        out["weight"] = w
        if "bias" in g and "bias" in p:
            out["bias"] = np.asarray(p["bias"])
    elif kind == "bn":
        _check(np.shape(p["scale"]), g["weight"].shape, torch_mod, flax_mod)
        out["weight"] = np.asarray(p["scale"])
        out["bias"] = np.asarray(p["bias"])
        out["running_mean"] = np.asarray(bs["mean"])
        out["running_var"] = np.asarray(bs["var"])
        # num_batches_tracked keeps the template's value: torch only reads
        # it when BN momentum=None (cumulative averaging) — never the case
        # in the reference models.
    elif kind == "ln":
        out["weight"] = np.asarray(p["scale"])
        if "bias" in g and "bias" in p:
            out["bias"] = np.asarray(p["bias"])
    else:
        raise ValueError(f"unhandled kind {kind} at {torch_mod['prefix']}")
    return out


def export_state_dict(
    variables: Dict, template_state_dict: Dict[str, Any],
    skip_classifier: bool = False,
) -> Dict[str, Any]:
    """Fill a torch state-dict TEMPLATE with this framework's weights —
    the exact inverse of convert_state_dict (same per-kind stream
    alignment, transposes inverted: HWIO->OIHW, (in,out)->(out,in)).

    `template_state_dict` supplies the torch key names and shapes: build
    the reference model (same architecture/n_cls) and pass its
    .state_dict().  `variables` must be insertion-ordered — straight from
    model.init or load_pretrained_params (tree_map/device_put SORT pytree
    keys and destroy the call-order information the alignment relies on).

    skip_classifier mirrors the import's drop_classifier (the reference's
    strict=False cross-task mode, helper/util.py:156-159): the flax
    'classifier' module is excluded and the template's trailing
    classifier keeps its own values.

    Returns {original template key -> numpy array} in template order;
    keys outside the conv/bn/linear/ln streams (num_batches_tracked,
    skipped classifiers) keep the template's values.  Every returned
    array is cast to the template tensor's dtype.
    """
    template = {
        k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
        for k, v in template_state_dict.items()
    }
    torch_mods = _torch_modules(template)

    def _copy(tree):
        if isinstance(tree, dict):
            return {k: _copy(v) for k, v in tree.items()}
        return np.asarray(tree)

    params = _copy(dict(variables["params"]))
    batch_stats = _copy(dict(variables.get("batch_stats", {})))
    flax_mods = _flax_modules(params, batch_stats)

    streams_f: Dict[str, List[dict]] = {}
    for m in flax_mods:
        streams_f.setdefault(m["kind"], []).append(m)
    streams_t: Dict[str, List[dict]] = {}
    for m in torch_mods:
        streams_t.setdefault(m["kind"], []).append(m)

    # refuse to half-fill: parameters outside the four aligned streams
    # (ViT cls_token/pos_embed) would silently keep template values
    handled = ("conv", "bn", "linear", "ln")
    stray_t = [m["prefix"] or "/".join(m["tensors"]) for m in torch_mods
               if m["kind"] not in handled]
    stray_f = ["/".join(m["path"]) for m in flax_mods
               if m["kind"] not in handled]
    if stray_t or stray_f:
        raise ValueError(
            "parameters outside the conv/bn/linear/ln streams cannot be "
            f"aligned (torch: {stray_t[:4]}, flax: {stray_f[:4]}) — "
            "ViT-class models interop via the npz path (models/vit_npz.py)")

    filled: Dict[str, Dict[str, Any]] = {}  # stripped prefix -> leaf vals
    for kind in ("conv", "bn", "linear", "ln"):
        fs = streams_f.get(kind, [])
        ts = streams_t.get(kind, [])
        if skip_classifier and kind == "linear":
            fs = [m for m in fs if m["path"][0] != "classifier"]
            if len(ts) < len(fs):
                raise ValueError(
                    "linear stream too short for the backbone even after "
                    f"skipping the classifier: flax {len(fs)} vs torch "
                    f"{len(ts)}"
                )
            ts = ts[: len(fs)]
        if len(fs) != len(ts):
            raise ValueError(
                f"{kind} stream length mismatch: flax {len(fs)} vs torch "
                f"{len(ts)} — architectures differ"
            )
        for fm, tm in zip(fs, ts):
            filled[tm["prefix"]] = _export_module(kind, fm, tm)

    out: Dict[str, Any] = {}
    for key, tmpl_val in template.items():
        name = key[len("module."):] if key.startswith("module.") else key
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if prefix in filled and leaf in filled[prefix]:
            out[key] = filled[prefix][leaf].astype(tmpl_val.dtype)
        else:
            out[key] = tmpl_val
    return out


def save_torch_checkpoint(path: str, state_dict: Dict[str, Any],
                          meta: Optional[Dict[str, Any]] = None) -> None:
    """torch.save `{'model': state_dict, **meta}` — the reference's
    training-checkpoint shape (train_teacher.py:306-332), which its
    load_pretrained_weights / test.py evaluation unwrap directly."""
    import torch

    obj = {"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in state_dict.items()}}
    obj.update(meta or {})
    torch.save(obj, path)
