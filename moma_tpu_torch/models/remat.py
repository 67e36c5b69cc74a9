"""Rematerialization: a forward whose activations are recomputed in the
backward instead of being held.

Counterpart of `jax.checkpoint` on the student forward (`--remat`,
moma_tpu/train/steps.py:56-59, distill.py:374-378, moma.py:519-523) and of
`nn.checkpoint` around each MBConv block (`EfficientNet(block_remat=True)`,
moma_tpu/models/efficientnet.py:246-253, :285-297).  Built on
`torch.utils.checkpoint` (non-reentrant), with two rules the JAX
functional forms keep by construction:

  * BatchNorm running statistics are written once, by the first forward:
    the replay runs under `fused_bn.running_stats_frozen()` (JAX keeps the
    forward's mutated batch_stats and drops the replay's);
  * an explicit `torch.Generator` draws the same numbers in the replay as
    in the forward (drop-connect, dropout): its state is taken when the
    forward starts and set again for the replay, then put back.  The
    global CPU and CUDA generators are restored by torch itself
    (preserve_rng_state).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from moma_tpu_torch.ops.fused_bn import running_stats_frozen


class _Forward:
    """The first run: note the generator's state."""

    def __init__(self, generator, saved: dict):
        self.generator, self.saved = generator, saved

    def __enter__(self):
        if self.generator is not None:
            self.saved["state"] = self.generator.get_state()

    def __exit__(self, *exc):
        return None


class _Replay:
    """The recompute: frozen running statistics, the forward's generator
    state while it runs and the generator's own state back afterwards."""

    def __init__(self, generator, saved: dict):
        self.generator, self.saved = generator, saved
        self.frozen = running_stats_frozen()

    def __enter__(self):
        self.frozen.__enter__()
        if self.generator is not None:
            self.after = self.generator.get_state()
            self.generator.set_state(self.saved["state"])

    def __exit__(self, *exc):
        if self.generator is not None:
            self.generator.set_state(self.after)
        self.frozen.__exit__(*exc)


def checkpoint(fn: Callable, *args,
               generator: Optional[torch.Generator] = None):
    """fn(*args), with the activations inside recomputed in the backward.
    `generator`: the torch.Generator that fn draws from, if any."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    saved: dict = {}
    return torch_checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (_Forward(generator, saved),
                            _Replay(generator, saved)))
