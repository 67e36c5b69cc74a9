"""Weights carried between moma_tpu (JAX) and moma_tpu_torch.

No counterpart module in moma_tpu: both directions go through the port's
copy of its converter (moma_tpu_torch.models.torch_import, numpy-only),
which aligns the conv / bn / linear / layernorm streams of the two
parameter trees in call order.  The port registers its modules in flax
call order for this.  A subtree without parameters (the 'None' projection
head is an empty dict in the JAX tree) is left out of the alignment.

  load_jax_variables(module, variables)  JAX -> port
      `variables` as numpy arrays, insertion-ordered as `init` returns them
      ({'params': ..., 'batch_stats': ...}), or a QueueState-like
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
    from moma_tpu_torch.moma.queue import QueueState

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
    sd = export_state_dict(_without_empty(variables), _numpy_state(module))
    own = module.state_dict()
    module.load_state_dict({
        k: torch.as_tensor(np.asarray(v)).to(own[k].device, own[k].dtype)
        for k, v in sd.items()})


def jax_variables(module: torch.nn.Module,
                  template: Dict[str, Any]) -> Dict[str, Any]:
    """The module's weights as a JAX-layout numpy tree shaped like
    `template` ({'params':..., 'batch_stats':...} from init)."""
    return convert_state_dict(_numpy_state(module), template)
