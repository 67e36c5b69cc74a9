"""Mixture-of-Experts ViT and its expert-parallel teacher.

Counterpart of moma_tpu/models/vit_moe.py: `MoEMLP` (:50-140), `MoEBlock`
(:143-163), `MoEVisionTransformer` (:166-225), `is_moe_model` and
`check_ep_teacher` (:228-250), the factories (:276-288), and, for
`moe_place` + `clone(ep_mesh=...)` (:253-273), `EPMoEVisionTransformer`.

Every `moe_every`-th block's MLP is an `MoEMLP`: token-choice top-k
routing (GShard / Switch) over E expert FFNs with a capacity of
cap = min(S, max(k, ceil(k*S*cf/E))) tokens an expert, S the tokens routed
together.  The JAX package dispatches through dense one-hot (S, E, cap)
einsums, the TPU's way to avoid gathers; here the tokens are gathered into
(E, cap, C) slots and scattered back by index, which computes the same:

  * router logits `x.float() @ router` (router (C, E), float32, never
    cast), softmax in float32;
  * the top k by a stable descending sort, so a tie goes to the lower
    expert index, as jax.lax.top_k breaks it; k = 1 gates by the raw
    probability, k > 1 renormalises the gates over the chosen experts;
  * GShard priority: token s's slot in expert e for its choice j is the
    number of earlier tokens (row-major over B x N) whose choice j is e,
    plus the number of all tokens whose earlier choices went to e; it is
    kept when the slot is below cap.  A dropped token adds nothing: the
    block's residual passes it through unchanged;
  * the expert FFNs gelu(x @ w1 + b1) @ w2 + b2 (exact GELU) in the
    compute dtype on the (E, cap, C) slots; an empty slot's output reaches
    no token and no gradient;
  * the combine: each slot's output times its gate cast to the compute
    dtype, added into a zeroed (S, C) output by index_add (k <= 2 terms a
    token);
  * the Switch load-balance value E * sum_e(f_e * mean_prob_e) over the
    first choices is kept as `aux` after each forward, over the tokens
    this process routed; nothing in training reads it, as in JAX.

Routing couples the rows of a batch through the capacity count, so its
scope is the batch of the step's semantics.  Inside `routing_scope(axis)`
(a core.mesh data axis of several ranks) the routed batch spans the ranks
of `axis`, rank by rank, as the JAX package's global-batch (GSPMD) step
sees it: each rank all_gathers every rank's per-expert counts of each
choice (one all_gather of a (k, E) integer tensor a MoE block, counted as
`moe_all_gather`), offsets its slots by the lower ranks' counts and takes
cap from the global S.  Outside it, routing is per process (JAX's
shard_map steps).  The training steps set it as they set the BN
statistics' group.

Expert parallelism: model rank m of MP holds experts [m*E/MP,
(m+1)*E/MP) of every MoE block and everything else whole.  The tokens of a
data row are the same on its model ranks, so each routes them alike, runs
its own experts and combines into a partial (S, C) output; one SUM
all_reduce over the model axis a MoE block (`model_all_reduce`, in the
compute dtype) gives JAX's sharded combine einsum.  With k <= 2 a token
has at most two nonzero terms, so the sum is exact in any order and the
expert-parallel forward equals the one-rank forward bit for bit wherever
the expert products do.  Forward only: the KL-teacher is frozen.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.common import default_generator
from moma_tpu_torch.models.vit import (MHSA, Block, LayerNorm, ViTBase,
                                       _lecun_)

_ROUTING = {"axis": None}


class routing_scope:
    """Context: MoE layers route the rows of every rank of `axis` (a
    core.mesh data axis) together, rank by rank; None, or an axis of one
    rank, routes each process's rows alone."""

    def __init__(self, axis):
        self.axis = axis if axis is not None and axis.world > 1 else None

    def __enter__(self):
        self.prev = _ROUTING["axis"]
        _ROUTING["axis"] = self.axis
        return self

    def __exit__(self, *exc):
        _ROUTING["axis"] = self.prev


class MoEMLP(nn.Module):
    """Top-k token-choice MoE FFN.  Holds experts [first, first + E_local)
    of `num_experts`: all of them, or under expert parallelism
    (EPMoEVisionTransformer) this model rank's, `axis` then the model axis
    its partial outputs are summed over."""

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        E = num_experts
        self.num_experts, self.top_k = E, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.first, self.axis = 0, None
        self.aux: Optional[torch.Tensor] = None
        self.router = nn.Parameter(torch.empty(dim, E))
        _lecun_(self.router, dim, g)
        self.w1 = nn.Parameter(torch.empty(E, dim, hidden))
        _lecun_(self.w1, dim, g)
        self.b1 = nn.Parameter(torch.zeros(E, hidden))
        self.w2 = nn.Parameter(torch.empty(E, hidden, dim))
        _lecun_(self.w2, hidden, g)
        self.b2 = nn.Parameter(torch.zeros(E, dim))

    def choose(self, probs: torch.Tensor):
        """(probabilities, experts) of each row's top k choices, highest
        first; a tie goes to the lower expert index (a stable sort)."""
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return vals[:, :self.top_k], idx[:, :self.top_k]

    def route(self, xf: torch.Tensor):
        """(gates (S, k) float32, experts (S, k), slots (S, k), cap) of
        the rows `xf` (S, C) in the current routing scope; a slot >= cap
        is a dropped choice."""
        E, k = self.num_experts, self.top_k
        S = xf.shape[0]
        scope = _ROUTING["axis"]
        world, rank = (scope.world, scope.rank) if scope else (1, 0)
        # JAX's expression (vit_moe.py:74) over every token routed together
        S_all = S * world
        cap = min(S_all, max(k, math.ceil(k * S_all * self.capacity_factor
                                          / E)))
        probs = torch.softmax(xf.float() @ self.router, dim=-1)
        vals, idx = self.choose(probs)
        if k > 1:
            # GShard top-2: the gates renormalised over the chosen experts
            vals = vals / vals.sum(-1, keepdim=True)
        # tokens last, so that the count over them is an innermost-dim scan
        oh = F.one_hot(idx, E).permute(1, 2, 0)                # (k, E, S)
        counts = oh.sum(-1)                                    # (k, E)
        # the Switch load-balance value over the first choices
        self.aux = (E * (counts[0].float() / S * probs.mean(0)).sum()
                    ).detach()
        if scope is not None:
            every = scope.gather(counts[None], kind="moe_all_gather")
            lower, counts = every[:rank].sum(0), every.sum(0)
        else:
            lower = torch.zeros_like(counts)
        # all tokens' earlier choices claim their slots first, then the
        # lower ranks' tokens of this choice, then this rank's earlier ones
        base = counts.cumsum(0) - counts + lower               # (k, E)
        slot = ((oh.cumsum(-1) - oh + base[..., None]) * oh).sum(1).t()
        return vals, idx, slot, cap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        S, k = B * N, self.top_k
        xf = x.reshape(S, C)
        gates, idx, slot, cap = self.route(xf)
        E_loc = self.w1.shape[0]
        # this module's experts' slots (E_loc * cap of them); every other
        # choice, dropped or another rank's, goes to a spare last slot
        mine = (slot < cap) & (idx >= self.first) & (idx < self.first + E_loc)
        spare = E_loc * cap
        target = torch.where(mine, (idx - self.first) * cap + slot,
                             spare).reshape(-1)
        tokens = torch.arange(S, device=x.device).repeat_interleave(k)
        # slot -> its token (S: an empty slot, which reads a zero row) and
        # its gate (0 for an empty slot)
        slot_token = torch.full((spare + 1,), S, dtype=torch.long,
                                device=x.device).scatter(0, target,
                                                         tokens)[:spare]
        slot_gate = gates.new_zeros(spare + 1).scatter(
            0, target, gates.reshape(-1))[:spare]
        dt = self.dtype or x.dtype
        xin = torch.cat([xf.to(dt), xf.new_zeros(1, C, dtype=dt)])[
            slot_token].reshape(E_loc, cap, C)
        h = F.gelu(torch.matmul(xin, self.w1.to(dt))
                   + self.b1.to(dt)[:, None], approximate="none")
        out = (torch.matmul(h, self.w2.to(dt))
               + self.b2.to(dt)[:, None]).reshape(spare, C)
        y = xf.new_zeros(S + 1, C, dtype=dt).index_add(
            0, slot_token, out * slot_gate.to(dt)[:, None])[:S]
        if self.axis is not None:
            if y.requires_grad:
                raise RuntimeError("the expert-parallel MoE forward "
                                   "carries no gradient")
            y = self.axis.all_reduce_(y.contiguous())
        return y.reshape(B, N, C)


class MoEBlock(nn.Module):
    """models/vit.Block with the MLP an MoEMLP (`moe`)."""

    def __init__(self, dim: int, num_heads: int, num_experts: int,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 mlp_ratio: float = 4.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = MHSA(dim, num_heads, dtype, generator)
        self.norm2 = LayerNorm(dim, dtype)
        self.moe = MoEMLP(dim, int(dim * mlp_ratio), num_experts, top_k,
                          capacity_factor, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.moe(self.norm2(x))


class MoEVisionTransformer(ViTBase):
    """A ViT with an MoE MLP in every `moe_every`-th block (GShard
    interleaving: blocks moe_every-1, 2*moe_every-1, ...); the feature
    contract of models/vit.VisionTransformer, which it does not subclass:
    the tensor- and pipeline-parallel routes (vit_tp.is_tp_model,
    vit_pp.is_pp_model) do not take it, as in JAX."""

    def __init__(self, patch_size: int = 16, dim: int = 192, depth: int = 12,
                 num_heads: int = 3, num_classes: int = 1000,
                 num_experts: int = 8, top_k: int = 1,
                 capacity_factor: float = 1.25, moe_every: int = 2,
                 image_size: int = 224, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.moe_every = capacity_factor, moe_every
        self._embeddings(patch_size, dim, num_heads, image_size, dtype, g)
        self.blocks = nn.ModuleList(
            MoEBlock(dim, num_heads, num_experts, top_k, capacity_factor,
                     dtype=dtype, generator=g) if self.is_moe_block(i)
            else Block(dim, num_heads, dtype=dtype, generator=g)
            for i in range(depth))
        self._head(dim, num_classes, dtype, g)

    def is_moe_block(self, i: int) -> bool:
        return (i % self.moe_every) == (self.moe_every - 1)

    def moe_layers(self):
        return [b.moe for b in self.blocks if isinstance(b, MoEBlock)]


def is_moe_model(model) -> bool:
    return isinstance(model, MoEVisionTransformer)


def check_ep_teacher(model, mp: int, teacher_quant: str = "none") -> None:
    """moma_tpu's check_ep_teacher, its messages: raise when expert
    parallelism cannot apply to this teacher at --model_parallel `mp`."""
    if not is_moe_model(model):
        raise ValueError(
            f"expert-parallel teacher requires a MoE ViT (vit_*_moe*), got "
            f"{type(model).__name__}")
    if model.num_experts % mp != 0:
        raise ValueError(
            f"teacher num_experts={model.num_experts} not divisible by "
            f"model_parallel={mp}")
    if teacher_quant != "none":
        raise ValueError(
            "--teacher_quant does not compose with the expert-parallel MoE "
            "teacher (quantization intercepts nn.Dense/Conv calls; the "
            "expert FFNs are batched einsums over (E, ...) parameters)")


_EXPERT = ("w1", "b1", "w2", "b2")


def _is_expert(key: str) -> bool:
    """A state-dict key of an expert-indexed tensor (w1 / b1 / w2 / b2 of
    an MoE block), JAX's moe_place criterion."""
    parts = key.split(".")
    return len(parts) == 4 and parts[2] == "moe" and parts[3] in _EXPERT


def ep_slices(state: Dict[str, torch.Tensor], index: int,
              size: int) -> Dict[str, torch.Tensor]:
    """Model rank `index` of `size`'s share of a dense MoE ViT's state
    dict: experts [index*E/size, (index+1)*E/size) of each expert-indexed
    tensor, everything else whole; each tensor a copy of its own."""
    return {k: (t.chunk(size, 0)[index] if _is_expert(k) else t).clone()
            for k, t in state.items()}


class EPMoEVisionTransformer(MoEVisionTransformer):
    """Model rank m's share of a dense MoEVisionTransformer on the model
    axis `axis`: E/MP experts of every MoE block, everything else the
    dense model's, whole (JAX's moe_place + clone(ep_mesh=...)).  Built
    from the dense model, whose other experts it drops."""

    def __init__(self, dense: MoEVisionTransformer, axis):
        check_ep_teacher(dense, axis.size)
        nn.Module.__init__(self)
        for name in ("patch_size", "num_heads", "grid", "feat_dim",
                     "num_experts", "top_k", "capacity_factor", "moe_every"):
            setattr(self, name, getattr(dense, name))
        self.axis = axis
        self.dense_keys = list(dense.state_dict())
        self.whole_block_bytes = sum(t.numel() * t.element_size()
                                     for t in dense.blocks.parameters())
        self.patch_embed = dense.patch_embed
        self.cls_token, self.pos_embed = dense.cls_token, dense.pos_embed
        self.blocks = dense.blocks
        self.norm, self.classifier = dense.norm, dense.classifier
        per = self.num_experts // axis.size
        for moe in self.moe_layers():
            moe.first, moe.axis = axis.index * per, axis
            for name in _EXPERT:
                t = getattr(moe, name)
                setattr(moe, name, nn.Parameter(
                    t.detach()[moe.first:moe.first + per].clone(),
                    requires_grad=t.requires_grad))

    def block_bytes(self) -> Tuple[int, int]:
        """(bytes of block weights this rank holds, bytes of the whole
        model's block weights)."""
        own = sum(t.numel() * t.element_size()
                  for t in self.blocks.parameters())
        return own, self.whole_block_bytes

    def expert_bytes(self) -> Tuple[int, int]:
        """(bytes of expert weights this rank holds, of all experts)."""
        own = sum(getattr(m, n).numel() * getattr(m, n).element_size()
                  for m in self.moe_layers() for n in _EXPERT)
        return own, own * self.axis.size

    def dense_state_dict(self) -> Dict[str, torch.Tensor]:
        """The dense model's state dict: every rank's experts all_gathered
        (one collective) and joined in model order."""
        own = {k: v.detach() for k, v in self.state_dict().items()}
        split = [k for k in own if _is_expert(k)]
        rows = self.axis.all_gather(
            torch.cat([own[k].reshape(-1) for k in split])[None], 0)
        parts = [row.split([own[k].numel() for k in split]) for row in rows]
        out = dict(own)
        for i, k in enumerate(split):
            out[k] = torch.cat([p[i].view_as(own[k]) for p in parts])
        return {k: out[k] for k in self.dense_keys}

    @torch.no_grad()
    def load_dense_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy this rank's experts and the whole parts of a dense state
        dict in place."""
        mine = ep_slices(state, self.axis.index, self.axis.size)
        own = self.state_dict()
        if set(mine) != set(own):
            raise ValueError("the checkpoint's teacher is not this MoE ViT: "
                             f"{sorted(set(mine) ^ set(own))[:4]}")
        for k, t in own.items():
            t.copy_(mine[k])


# name -> (dim, depth, heads); patch 16, 8 experts
MOE_CONFIGS = {"vit_tiny_moe_patch16_224": (192, 12, 3),
               "vit_small_moe_patch16_224": (384, 12, 6)}


def moe_factory(name: str, num_classes: int, image_size: int,
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                **kw) -> MoEVisionTransformer:
    """JAX's `_moe_factory` models: 8 experts, top-1, capacity factor
    1.25, MoE in the odd blocks unless `kw` says otherwise."""
    dim, depth, heads = MOE_CONFIGS[name]
    return MoEVisionTransformer(16, dim, depth, heads, num_classes,
                                image_size=image_size, dtype=dtype,
                                generator=generator, **kw)
