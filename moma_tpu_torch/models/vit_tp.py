"""Tensor-parallel ViT teacher: Megatron 1-D tensor parallelism over the
model axis for the fixed (gradient-free) ViT KL-teacher of a cross-arch
run at --model_parallel MP.

Counterpart of moma_tpu/models/vit_tp.py: `is_tp_model` (:52),
`check_tp_teacher` (:57-82), `tp_convert` (:84-121) and
`make_tp_vit_apply` (:174-299).  The JAX package shards the converted
weights by annotation and lets GSPMD place the collectives; here model rank
m holds its slices and runs explicit `torch.distributed` collectives on the
model group (core/mesh.model_axis):

  * weights (`tp_slices`): q, k and v of heads [m*H/MP, (m+1)*H/MP), cut
    out of the fused qkv Dense in its [3, H, hd] output order (a contiguous
    3C/MP chunk would mix q, k and v), the out-projection's inputs of those
    heads, and the MLP up-projection's outputs and bias and the
    down-projection's inputs [m*F/MP, (m+1)*F/MP).  The patch embedding,
    cls token, position embedding, LayerNorms, the two biases added after a
    reduction and the classifier stay whole.  A rank stores 1/MP of every
    block's attention and MLP weights;
  * forward: two all_reduce(SUM)s a block, after the out-projection and
    after the MLP down-projection, each on partial sums over this rank's
    heads / hidden units; the replicated bias is added once, after the
    reduction.  The softmax runs in float32, as in models/vit.MHSA;
  * `sequence_parallel`: between blocks the residual stream is sharded
    over tokens, so LayerNorm (per token: exact on a shard) and the
    residual adds run on this rank's tokens; each block's two reductions
    become reduce_scatters over tokens, and the inputs of the qkv and
    MLP-up projections are all_gathered over tokens first.  The token
    count (197 at 224^2, 577 at 384^2) is padded to a multiple of MP; the
    padding is dropped right after each all_gather, so it never enters a
    product or a softmax as a key, and before the epilogue, which reads
    the cls token (token 0) after the last gather.

The collectives count as `model_all_reduce`, `model_reduce_scatter` and
`model_all_gather` in core/mesh.comm_counts.  The module answers
`dense_state_dict()` (the whole teacher, gathered from the ranks' slices:
checkpoints hold it, so a run resumes at any --model_parallel and
--teacher_parallel) and `load_dense_state_dict` (each rank takes its
slices).  Forward only: the teacher is frozen in EmaTec mode.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from moma_tpu_torch.models.vit import Block, VisionTransformer

# state-dict suffix of a block -> how model rank m takes its share: 'qkv'
# (the [3, H, hd] output rows of its heads), a dimension to chunk, or
# whole (absent)
_SPLIT = {"attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv",
          "attn.proj.weight": 1, "fc1.weight": 0, "fc1.bias": 0,
          "fc2.weight": 1}


def is_tp_model(model) -> bool:
    """Only the ViT family has the clean head / hidden decomposition."""
    return isinstance(model, VisionTransformer)


def check_tp_teacher(model, mp: int, teacher_quant: str = "none") -> None:
    """moma_tpu's check_tp_teacher, its messages: raise when TP cannot
    apply to this teacher at --model_parallel `mp`."""
    if not is_tp_model(model):
        raise ValueError(
            f"tensor-parallel teacher requires a ViT family model, got "
            f"{type(model).__name__}")
    if model.num_heads % mp != 0:
        raise ValueError(
            f"teacher num_heads={model.num_heads} not divisible by "
            f"model_parallel={mp}")
    if int(model.feat_dim * 4.0) % mp != 0:
        raise ValueError(
            f"teacher MLP hidden dim {int(model.feat_dim * 4.0)} not "
            f"divisible by model_parallel={mp}")
    if teacher_quant != "none":
        raise ValueError(
            "--teacher_quant does not compose with the tensor-parallel ViT "
            "teacher (quantization intercepts Flax module calls; the TP "
            "attention/MLP contractions are functional einsums)")


def _share(t: torch.Tensor, how, index: int, size: int) -> torch.Tensor:
    if how == "qkv":
        three = t.reshape(3, -1, *t.shape[1:])
        return three.chunk(size, 1)[index].reshape(-1, *t.shape[1:])
    return t.chunk(size, how)[index]


def tp_slices(state: Dict[str, torch.Tensor], index: int,
              size: int) -> Dict[str, torch.Tensor]:
    """Model rank `index` of `size`'s share of a dense VisionTransformer's
    state dict (module docstring), under the same keys, each a copy of its
    own."""
    out = {}
    for key, t in state.items():
        how = (_SPLIT.get(key.split(".", 2)[2])
               if key.startswith("blocks.") else None)
        out[key] = (t if how is None else _share(t, how, index, size)).clone()
    return out


def tp_join(shares: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The dense state dict from every model rank's `tp_slices`, in model
    order (tp_slices' inverse)."""
    out = {}
    for key, t in shares[0].items():
        how = (_SPLIT.get(key.split(".", 2)[2])
               if key.startswith("blocks.") else None)
        if how is None:
            out[key] = t
        elif how == "qkv":
            out[key] = torch.cat([s[key].reshape(3, -1, *t.shape[1:])
                                  for s in shares], 1).reshape(
                                      -1, *t.shape[1:])
        else:
            out[key] = torch.cat([s[key] for s in shares], how)
    return out


def _linear(x: torch.Tensor, dense: nn.Module, bias: bool = True):
    """models/vit.Dense's forward (operands cast to its dtype, or
    promoted), without the bias when `bias` is False."""
    dt = (dense.dtype if dense.dtype is not None
          else torch.promote_types(x.dtype, dense.weight.dtype))
    return F.linear(x.to(dt), dense.weight.to(dt),
                    dense.bias.to(dt) if bias else None)


class TPBlock(nn.Module):
    """A ViT block over this rank's heads and MLP hidden units.  It keeps
    models/vit.Block's submodule names, its tensors cut by tp_slices."""

    def __init__(self, block: Block, axis, sequence_parallel: bool):
        super().__init__()
        size = axis.size
        self.axis, self.sequence_parallel = axis, sequence_parallel
        self.heads = block.attn.num_heads // size
        # models/vit.Block's order, so the state dicts' keys align
        self.norm1, self.attn = block.norm1, block.attn
        self.norm2 = block.norm2
        self.fc1, self.fc2 = block.fc1, block.fc2
        state = {f"blocks.0.{k}": v for k, v in block.state_dict().items()}
        for key, t in tp_slices(state, axis.index, size).items():
            path, name = key.split(".", 2)[2].rsplit(".", 1)
            setattr(self.get_submodule(path), name,
                    nn.Parameter(t, requires_grad=False))

    def _gather(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """Sequence-parallel: the whole token axis of this rank's shard,
        the padding dropped."""
        return self.axis.all_gather(y, 1)[:, :n]

    def _reduce(self, z: torch.Tensor, bias: torch.Tensor,
                n_pad: int) -> torch.Tensor:
        """The sum of the ranks' partial products (a reduce_scatter over
        tokens under sequence parallelism), then the replicated bias."""
        if self.sequence_parallel:
            z = F.pad(z, (0, 0, 0, n_pad - z.shape[1]))
            z = self.axis.reduce_scatter(z, 1)
        else:
            z = self.axis.all_reduce_(z.contiguous())
        return z + bias.to(z.dtype)

    def forward(self, x: torch.Tensor, n_tokens: int) -> torch.Tensor:
        """x: (B, tokens, C), or under sequence parallelism this rank's
        (B, padded tokens / MP, C); `n_tokens` the real token count."""
        n_pad = x.shape[1] * self.axis.size
        y = self.norm1(x)
        if self.sequence_parallel:
            y = self._gather(y, n_tokens)
        B, N, _ = y.shape
        h = self.heads
        qkv = _linear(y, self.attn.qkv).reshape(B, N, 3, h, -1).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = (q @ k.transpose(-2, -1)) * (q.shape[-1] ** -0.5)
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        o = (att @ v).transpose(1, 2).reshape(B, N, -1)
        x = x + self._reduce(_linear(o, self.attn.proj, bias=False),
                             self.attn.proj.bias, n_pad)
        y = self.norm2(x)
        if self.sequence_parallel:
            y = self._gather(y, n_tokens)
        hid = F.gelu(_linear(y, self.fc1), approximate="none")
        return x + self._reduce(_linear(hid, self.fc2, bias=False),
                                self.fc2.bias, n_pad)


class TPVisionTransformer(VisionTransformer):
    """A VisionTransformer whose blocks are this model rank's TPBlocks;
    the patch embedding, cls / position embeddings, final norm and
    classifier are the dense model's, whole.  Built from a dense model,
    whose blocks it replaces (its storage can go)."""

    def __init__(self, dense: VisionTransformer, axis,
                 sequence_parallel: bool = False):
        check_tp_teacher(dense, axis.size)
        nn.Module.__init__(self)
        for name in ("patch_size", "num_heads", "grid", "feat_dim"):
            setattr(self, name, getattr(dense, name))
        self.axis, self.sequence_parallel = axis, sequence_parallel
        self.whole_block_bytes = sum(t.numel() * t.element_size()
                                     for t in dense.blocks.parameters())
        self.patch_embed = dense.patch_embed
        self.cls_token, self.pos_embed = dense.cls_token, dense.pos_embed
        self.blocks = nn.ModuleList(TPBlock(b, axis, sequence_parallel)
                                    for b in dense.blocks)
        self.norm, self.classifier = dense.norm, dense.classifier

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        if not self.sequence_parallel:
            for blk in self.blocks:
                x = blk(x, n)
            return x
        size, index = self.axis.size, self.axis.index
        n_loc = -(-n // size)
        x = F.pad(x, (0, 0, 0, n_loc * size - n))
        x = x[:, index * n_loc:(index + 1) * n_loc].contiguous()
        for blk in self.blocks:
            x = blk(x, n)
        return self.axis.all_gather(x, 1)[:, :n]

    def block_bytes(self) -> Tuple[int, int]:
        """(bytes of block weights this rank holds, bytes of the whole
        model's block weights)."""
        own = sum(t.numel() * t.element_size()
                  for t in self.blocks.parameters())
        return own, self.whole_block_bytes

    def dense_state_dict(self) -> Dict[str, torch.Tensor]:
        """The dense VisionTransformer's state dict: every rank's slices
        all_gathered (one collective) and joined."""
        own = {k: v.detach() for k, v in self.state_dict().items()}
        split = [k for k in own if k.startswith("blocks.")
                 and _SPLIT.get(k.split(".", 2)[2]) is not None]
        flat = torch.cat([own[k].reshape(-1) for k in split])
        rows = self.axis.all_gather(flat[None], 0)
        shares = []
        for row in rows:
            parts = row.split([own[k].numel() for k in split])
            shares.append({**own, **{k: p.view_as(own[k])
                                     for k, p in zip(split, parts)}})
        return tp_join(shares)

    @torch.no_grad()
    def load_dense_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy this rank's slices of a dense state dict in place."""
        mine = tp_slices(state, self.axis.index, self.axis.size)
        own = self.state_dict()
        if set(mine) != set(own):
            raise ValueError("the checkpoint's teacher is not this ViT: "
                             f"{sorted(set(mine) ^ set(own))[:4]}")
        for k, t in own.items():
            t.copy_(mine[k])
