"""Weights carried between moma_tpu (JAX) and moma_tpu_torch.

No counterpart module in moma_tpu: both directions go through the port's
copy of its converter (moma_tpu_torch.models.torch_import, numpy-only),
which aligns the conv / bn / linear / layernorm streams of the two
parameter trees in call order.  The port registers its modules in flax
call order for this.  A subtree without parameters (the 'None' projection
head is an empty dict in the JAX tree) is left out of the alignment.

A ViT (models/vit.py) has parameters outside those streams (cls_token,
pos_embed), which the converter refuses on purpose; it crosses through
the explicit name map `vit_name_map` instead, with the transposes of a
Dense kernel ((in, out) <-> (out, in)) and of the patch conv (HWIO <->
OIHW).  Every tensor on both sides must be mapped: a port tensor left at
its own value, or a JAX leaf left unread, raises.

  load_jax_variables(module, variables)  JAX -> port
      `variables` as numpy arrays, insertion-ordered as `init` returns them
      ({'params': ..., 'batch_stats': ...}; a fixed RFFHead's
      {'constants': {'B_w', 'B_b'}}), or a QueueState-like
      {'memory': {name: (K, D)}, 'ptr': int} for a port QueueState (one
      bank 'memory', or the dual banks 'memory_s' / 'memory_t').
  jax_variables(module, template)        port -> JAX layout
      the port module's current weights shaped like `template` (an
      insertion-ordered init tree), for comparing with a JAX state whose
      dict keys may since have been re-sorted.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from moma_tpu_torch.models.torch_import import (convert_state_dict,
                                                export_state_dict)
from moma_tpu_torch.models.vit import VisionTransformer


def vit_name_map(depth: int):
    """[(port state-dict key, JAX variables path, layout)] of a ViT of
    `depth` blocks; layout 'conv' (HWIO <-> OIHW), 'dense' ((in, out) <->
    (out, in)) or None."""
    m = [("patch_embed.weight", ("patch_embed", "kernel"), "conv"),
         ("patch_embed.bias", ("patch_embed", "bias"), None),
         ("cls_token", ("cls_token",), None),
         ("pos_embed", ("pos_embed",), None)]
    for i in range(depth):
        b, j = f"blocks.{i}", f"Block_{i}"
        for ours, theirs, layout in (
                ("norm1", ("LayerNorm_0",), None),
                ("attn.qkv", ("MHSA_0", "Dense_0"), "dense"),
                ("attn.proj", ("MHSA_0", "Dense_1"), "dense"),
                ("norm2", ("LayerNorm_1",), None),
                ("fc1", ("Dense_0",), "dense"),
                ("fc2", ("Dense_1",), "dense")):
            w = "scale" if layout is None else "kernel"
            m += [(f"{b}.{ours}.weight", (j, *theirs, w), layout),
                  (f"{b}.{ours}.bias", (j, *theirs, "bias"), None)]
    m += [("norm.weight", ("norm", "scale"), None),
          ("norm.bias", ("norm", "bias"), None),
          ("classifier.weight", ("classifier", "kernel"), "dense"),
          ("classifier.bias", ("classifier", "bias"), None)]
    return [(k, ("params", *path), layout) for k, path, layout in m]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _to_port(a: np.ndarray, layout) -> np.ndarray:
    a = np.asarray(a)
    if layout == "conv":
        a = np.transpose(a, (3, 2, 0, 1))
    elif layout == "dense":
        a = a.T
    return np.array(a)


def _to_jax(a: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a.T if layout == "dense" else a


def _vit_pairs(module, variables):
    """(port key, JAX path, layout) of the ViT name map, checked to cover
    every tensor of the module and every leaf of `variables`."""
    names = vit_name_map(len(module.blocks))
    own = set(module.state_dict())
    mapped = {k for k, _, _ in names}
    leaves = {p for p, _ in _leaves(_without_empty(dict(variables)))}
    paths = {p for _, p, _ in names}
    if own != mapped or leaves != paths:
        raise ValueError(
            "ViT trees do not match the name map: port tensors unmapped "
            f"{sorted(own - mapped)[:4]}, map keys not in the port "
            f"{sorted(mapped - own)[:4]}, JAX leaves unmapped "
            f"{sorted(leaves - paths)[:4]}, map paths not in the JAX tree "
            f"{sorted(paths - leaves)[:4]}")
    return names


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _numpy_state(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().float().numpy()
            for k, v in module.state_dict().items()}


def _without_empty(tree):
    """The nested dict without its parameter-free subtrees, order kept."""
    if not isinstance(tree, dict):
        return tree
    kept = {k: _without_empty(v) for k, v in tree.items()}
    return {k: v for k, v in kept.items()
            if not (isinstance(v, dict) and not v)}


def load_jax_variables(module, variables: Dict[str, Any]) -> None:
    """Fill `module` in place from JAX variables (see module docstring)."""
    from moma_tpu_torch.moma.cmo import RFFHead
    from moma_tpu_torch.moma.queue import QueueState

    if isinstance(module, RFFHead):
        # a fixed head's one draw, JAX's 'constants' collection
        with torch.no_grad():
            for name in ("B_w", "B_b"):
                getattr(module, name).copy_(torch.as_tensor(
                    np.array(variables["constants"][name])))
        return
    if isinstance(module, QueueState):
        if set(variables["memory"]) != set(module.memory):
            raise ValueError(
                f"queue banks differ: {sorted(variables['memory'])} vs "
                f"{sorted(module.memory)}")
        for name, mem in variables["memory"].items():
            module.memory[name] = torch.as_tensor(
                np.asarray(mem), dtype=torch.float32,
                device=module.memory[name].device).clone()
        module.ptr = int(np.asarray(variables.get("ptr", 0)))
        return
    own = module.state_dict()
    if isinstance(module, VisionTransformer):
        sd = {}
        for key, path, layout in _vit_pairs(module, variables):
            v = _to_port(_get(variables, path), layout)
            if tuple(v.shape) != tuple(own[key].shape):
                raise ValueError(f"{'/'.join(path)} {v.shape} does not fit "
                                 f"{key} {tuple(own[key].shape)}")
            sd[key] = v
    else:
        sd = export_state_dict(_without_empty(variables),
                               _numpy_state(module))
    module.load_state_dict({
        k: torch.as_tensor(np.asarray(v)).to(own[k].device, own[k].dtype)
        for k, v in sd.items()})


def jax_variables(module: torch.nn.Module,
                  template: Dict[str, Any]) -> Dict[str, Any]:
    """The module's weights as a JAX-layout numpy tree shaped like
    `template` ({'params':..., 'batch_stats':...} from init)."""
    from moma_tpu_torch.moma.cmo import RFFHead

    if isinstance(module, RFFHead):
        return {"constants": _numpy_state(module)}
    if not isinstance(module, VisionTransformer):
        return convert_state_dict(_numpy_state(module), template)
    state = _numpy_state(module)
    out = {}
    for key, path, layout in _vit_pairs(module, template):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_jax(state[key], layout)
    return out
