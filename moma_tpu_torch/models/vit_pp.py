"""Pipeline-parallel ViT teacher: GPipe over the model axis for the fixed
(gradient-free) ViT KL-teacher of a cross-arch run at --model_parallel S
--teacher_parallel pipeline.

Counterpart of moma_tpu/models/vit_pp.py: `is_pp_model` (:55),
`check_pp_teacher` (:60-92), `pp_stack` (:94) and `make_pp_vit_apply`
(:129-256).  Stage s (model rank s) keeps blocks [s*depth/S,
(s+1)*depth/S) whole and drops the others.  The patch embedding and the
norm / classifier epilogue run on every rank, outside the pipeline.  The
local batch splits into T = --pp_microbatch (default S) microbatches, run
over T + S - 1 ticks: stage 0 takes microbatch t, every stage runs its
blocks on what it holds, and the activations hop to stage s + 1 through
model_axis().ppermute, a cyclic shift whose wrap-around stage 0 ignores (as
JAX's open chain `fwd_ring`).  A stage with no microbatch at a tick (the
bubble) runs nothing and sends what it holds; only the last stage's outputs
of real microbatches are kept (JAX's `oidx >= 0` guard).  The last stage
then broadcasts the finished tokens to every model rank (JAX: a psum of
zeros elsewhere).  Microbatching splits the batch only and attention mixes
tokens within a sample, so the result is the dense forward's up to
reduction order.

`dense_state_dict()` gathers the stages' blocks (one all_gather), so
checkpoints hold the whole teacher; `load_dense_state_dict` takes this
stage's blocks.  Forward only: the teacher is frozen in EmaTec mode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from moma_tpu_torch.models.vit import VisionTransformer


def is_pp_model(model) -> bool:
    """Uniform-depth transformer stacks pipeline cleanly."""
    return isinstance(model, VisionTransformer)


def check_pp_teacher(model, mp: int, n_data: int, n_micro: int,
                     batch_size=None, teacher_quant: str = "none") -> None:
    """moma_tpu's check_pp_teacher on a (n_data x mp) grid, its messages;
    `batch_size` the global batch each teacher forward sees (the
    accumulation microbatch under --grad_accum)."""
    if not is_pp_model(model):
        raise ValueError(
            f"pipeline-parallel teacher requires a ViT family model, got "
            f"{type(model).__name__}")
    if mp < 2:
        raise ValueError("pipeline parallelism requires model_parallel > 1")
    depth = len(model.blocks)
    if depth % mp != 0:
        raise ValueError(
            f"teacher depth={depth} not divisible by "
            f"model_parallel={mp} pipeline stages")
    if n_micro < 1:
        raise ValueError(f"pp_microbatch must be >= 1, got {n_micro}")
    if batch_size is not None:
        local = batch_size // n_data
        if batch_size % n_data or local % n_micro:
            raise ValueError(
                f"per-device batch {batch_size}/{n_data} "
                f"not divisible by pp_microbatch={n_micro}")
    if teacher_quant != "none":
        raise ValueError(
            "--teacher_quant does not compose with the pipeline-parallel "
            "ViT teacher (quantization intercepts Flax module calls; the "
            "pipeline body scans stacked raw parameters)")


class PPVisionTransformer(VisionTransformer):
    """A VisionTransformer holding this stage's blocks (under their global
    indices, so its state-dict keys are the dense model's) and running the
    GPipe schedule over the model axis; built from a dense model, whose
    other blocks it drops."""

    def __init__(self, dense: VisionTransformer, axis,
                 n_micro: int = 0, n_data: int = 1):
        check_pp_teacher(dense, axis.size, n_data, n_micro or axis.size)
        nn.Module.__init__(self)
        for name in ("patch_size", "num_heads", "grid", "feat_dim"):
            setattr(self, name, getattr(dense, name))
        self.axis, self.n_data = axis, n_data
        self.n_micro = n_micro or axis.size
        self.depth = len(dense.blocks)
        per = self.depth // axis.size
        self.first = axis.index * per
        self.dense_keys = list(dense.state_dict())
        self.patch_embed = dense.patch_embed
        self.cls_token, self.pos_embed = dense.cls_token, dense.pos_embed
        self.blocks = nn.ModuleDict(
            {str(i): dense.blocks[i]
             for i in range(self.first, self.first + per)})
        self.norm, self.classifier = dense.norm, dense.classifier

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks.values():
            x = blk(x)
        return x

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        S, s, T = self.axis.size, self.axis.index, self.n_micro
        B = x.shape[0]
        if B % T:
            raise ValueError(
                f"per-device batch {B * self.n_data}/{self.n_data} not "
                f"divisible by pp_microbatch={T}")
        micro = x.chunk(T)
        outs = [None] * T
        held = torch.zeros_like(micro[0])
        for t in range(T + S - 1):
            j = t - s          # the microbatch this stage holds at tick t
            if 0 <= j < T:
                held = self._stage(micro[j] if s == 0 else held)
                if s == S - 1:
                    outs[j] = held
            if t < T + S - 2:  # the last tick's hop reaches no stage
                held = self.axis.ppermute([held])[0]
        out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
        return self.axis.broadcast_(out, S - 1)

    def block_bytes(self) -> Tuple[int, int]:
        """(bytes of block weights this stage holds, bytes of the whole
        model's block weights)."""
        own = sum(t.numel() * t.element_size()
                  for t in self.blocks.parameters())
        return own, own * self.axis.size

    def dense_state_dict(self) -> Dict[str, torch.Tensor]:
        """The dense VisionTransformer's state dict: every stage's blocks
        all_gathered (one collective) under their global indices."""
        own = {k: v.detach() for k, v in self.state_dict().items()}
        keys = [k for k in own if k.startswith("blocks.")]
        rows = self.axis.all_gather(
            torch.cat([own[k].reshape(-1) for k in keys])[None], 0)
        per = len(self.blocks)
        out = dict(own)
        for stage, row in enumerate(rows):
            for k, part in zip(keys, row.split([own[k].numel()
                                                for k in keys])):
                _, i, rest = k.split(".", 2)
                g = int(i) - self.first + stage * per
                out[f"blocks.{g}.{rest}"] = part.view_as(own[k])
        return {k: out[k] for k in self.dense_keys}

    @torch.no_grad()
    def load_dense_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy this stage's blocks and the whole parts of a dense state
        dict in place."""
        odd = sorted(set(state) ^ set(self.dense_keys))
        if odd:
            raise ValueError("the checkpoint's teacher is not this ViT: "
                             f"{odd[:4]}")
        for k, t in self.state_dict().items():
            t.copy_(state[k])
