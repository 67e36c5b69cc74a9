"""Device resolution and kernel launch counters.

No counterpart in `moma_tpu` (JAX picks its backend globally).  Here every
entry point takes an explicit device; asking for CUDA on a machine without
one is an error, never a silent fall back to the CPU.

The launch counters let a run prove that its main path went through the
hand-written kernels: each kernel wrapper in `moma_tpu_torch.ops` adds one
to its count at the point where it launches its CUDA kernel, and nowhere
else (the plain PyTorch version taken for CPU tensors does not count).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Union

import torch

_LAUNCHES: Counter = Counter()


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def count_launch(name: str, n: int = 1) -> None:
    _LAUNCHES[name] += n


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)
