"""Checkpoint save/restore and the run's statistics files.

Counterpart of moma_tpu/core/checkpoint.py (`CheckpointManager` :21,
`StatsWriter` :87).  A checkpoint is one `torch.save` of the whole train
state (student and teacher with their BN buffers, the CMO heads, every
queue bank and its pointer, the optimizer's momentum buffers and the step)
to `<dir>/<tag>.pt`: `latest` for resume, `best_acc` / `best_f1` for the
reference's best-metric snapshots.

The file is written to a temporary name and moved into place with
`os.replace`, and its `<tag>.meta.json` sidecar is written only after
that, so a meta file marks a COMPLETE checkpoint (resume and preemption
logic read it; `exists` asks for both).  Saves are synchronous: `wait`
stays for the interface of the JAX package, whose saves may commit on a
background thread.  Restores load onto the run's device (`map_location`),
never silently onto another one.

In a process group (core/mesh.py) every rank holds the same state (a
split negative bank is gathered whole before the save, train/moma.py
`full_state`): rank 0 writes the checkpoint and the stat files, then every
rank meets at a barrier, so a rank-0 checkpoint is a one-process
checkpoint; every rank restores from the file.  The other ranks'
StatsWriters write nothing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from moma_tpu_torch.core.mesh import world_axis
from moma_tpu_torch.core.tb_writer import TBWriter


def _write_json(path: str, payload: Any, **kw) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, **kw)
    os.replace(tmp, path)


class CheckpointManager:
    """`<dir>/<tag>.pt` plus `<dir>/<tag>.meta.json` per tag."""

    def __init__(self, directory: str, map_location=None):
        self.directory = os.path.abspath(directory)
        self.map_location = map_location
        os.makedirs(self.directory, exist_ok=True)

    def path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.pt")

    def _meta_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.meta.json")

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def save(self, tag: str, state: Any, meta: Optional[dict] = None) -> None:
        ax = world_axis()
        if ax.rank == 0:
            # the old sidecar goes first: until the new one is written, the
            # tag holds no complete checkpoint rather than a mismatched pair
            if os.path.exists(self._meta_path(tag)):
                os.remove(self._meta_path(tag))
            tmp = self.path(tag) + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self.path(tag))
            _write_json(self._meta_path(tag), meta or {}, default=float)
        ax.barrier()

    def restore(self, tag: str) -> Any:
        return torch.load(self.path(tag), map_location=self.map_location,
                          weights_only=True)

    def exists(self, tag: str) -> bool:
        return (os.path.exists(self.path(tag))
                and os.path.exists(self._meta_path(tag)))

    def meta(self, tag: str) -> Optional[dict]:
        p = self._meta_path(tag)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None


class StatsWriter:
    """Per-epoch `stat.json` history, a JSONL stream of step scalars
    (`scalars.jsonl`) and TensorBoard event files under `tb/`, as in the
    JAX package."""

    def __init__(self, directory: str):
        self.enabled = world_axis().rank == 0
        if not self.enabled:
            return
        os.makedirs(directory, exist_ok=True)
        self.stat_path = os.path.join(directory, "stat.json")
        self.scalar_path = os.path.join(directory, "scalars.jsonl")
        self._stats = {}
        if os.path.exists(self.stat_path):
            with open(self.stat_path) as f:
                self._stats = json.load(f)
        self._tb = TBWriter(os.path.join(directory, "tb"))

    def update_epoch(self, epoch: int, values: dict):
        if not self.enabled:
            return
        self._stats[str(epoch)] = {
            k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
            for k, v in values.items()
        }
        _write_json(self.stat_path, self._stats)
        for k, v in values.items():
            if (isinstance(v, (int, float, np.floating))
                    and not isinstance(v, bool)):
                self._tb.scalar(f"epoch/{k}", float(v), epoch)
        self._tb.flush()

    def scalar(self, step: int, **values):
        if not self.enabled:
            return
        with open(self.scalar_path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in
                                                 values.items()}}) + "\n")
        self._tb.scalars(step, **values)

    def write_params_json(self, directory: str, payload: dict):
        """parameters.json: the run's flags and best metrics."""
        if not self.enabled:
            return
        with open(os.path.join(directory, "parameters.json"), "w") as f:
            json.dump(payload, f, indent=2, default=str)

    def close(self):
        if self.enabled:
            self._tb.close()
