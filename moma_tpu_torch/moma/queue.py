"""MoCo negative-queue state machine.

Counterpart of moma_tpu/moma/queue.py: `QueueState` (:33-49),
`queue_logits` (:52-59), `pos_logits` (:62-64), `queue_update` (:67-80),
the four memory variants `step_moco` (:85-99), `step_moco_att` (:102-145,
attention applied to q / k / queue inside the step), `step_moco_st`
(:148-171, dual student / teacher banks) and `step_moco_sstt` (:174-203,
dual banks x dual queries), and `contrast_ce` (:504-507).  The logits always come from the PRE-update
memory (read before write, as the reference's mem_moco.py:89-99); the
update builds a new memory tensor rather than writing in place, because
autograd holds the old one for the gradient of the negative logits.

The initial memory is an argument: moma_tpu draws it from JAX's threefry
(`QueueState.create`), which torch cannot reproduce; `random_memory` draws
one from a torch.Generator for standalone runs.

The `*_sharded` variants (:206-501) hold the bank split by rows over the
model ranks of a data row (core/mesh.model_axis; `--model_parallel`): rank
m keeps global rows [m*K/MP, (m+1)*K/MP) and the pointer, which every rank
keeps whole.  Each computes its (B, K/MP) block of negative logits and
all-gathers the blocks along dim 1, so every rank holds the full logits
and the loss is replicated over the model ranks.  Two autograd identities
correct the gradients as JAX's custom VJPs do: `_grad_psum` (backward: the
model-pmean of the cotangent) on the query, so every rank gets the full
dq, and `_grad_div` (backward: the cotangent / MP) on a bank block that
carries a gradient (the ring-transformed bank of MoCoAtt).  The circular
write touches only this rank's rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclass
class QueueState:
    memory: Dict[str, torch.Tensor]  # name -> (K, D) L2-normalized rows
    ptr: int = 0                     # shared across banks

    @property
    def K(self) -> int:
        return next(iter(self.memory.values())).shape[0]


def random_memory(K: int, dim: int, generator: torch.Generator,
                  device="cpu") -> torch.Tensor:
    """(K, dim) rows drawn N(0,1) and L2-normalized (the distribution of
    QueueState.create; the draws differ from JAX's)."""
    m = torch.randn(K, dim, generator=generator)
    return (m / m.norm(dim=1, keepdim=True)).to(device)


def queue_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                 T: float) -> torch.Tensor:
    """[pos | negs] / T — (B, 1+K), positive at column 0."""
    pos = (q * k).sum(1, keepdim=True)
    neg = q @ queue.t()
    return torch.cat([pos, neg], dim=1) / T


def pos_logits(q: torch.Tensor, k: torch.Tensor, T: float) -> torch.Tensor:
    """Positive-only variant, (B, 1); used by MoCoAtt 'dual2'."""
    return (q * k).sum(1, keepdim=True) / T


def queue_update(state: QueueState,
                 new_keys: Dict[str, torch.Tensor]) -> QueueState:
    """Circular write of the keys at the pointer; advance by their count."""
    n = next(iter(new_keys.values())).shape[0]
    K = state.K
    dev = next(iter(state.memory.values())).device
    idx = (state.ptr + torch.arange(n, device=dev)) % K
    mems = dict(state.memory)
    for name, keys in new_keys.items():
        mems[name] = state.memory[name].index_copy(
            0, idx, keys.detach().to(state.memory[name].dtype))
    return QueueState(memory=mems, ptr=(state.ptr + n) % K)


def step_moco(state: QueueState, q: torch.Tensor, k: torch.Tensor,
              all_k: Optional[torch.Tensor],
              T: float) -> Tuple[torch.Tensor, QueueState]:
    """MoCo: logits from the pre-update queue, then enqueue all_k."""
    k = k.detach()
    queue = state.memory["memory"].detach()
    logits = queue_logits(q, k, queue, T)
    all_k = k if all_k is None else all_k
    return logits, queue_update(state, {"memory": all_k})


def step_moco_att(state: QueueState, q: torch.Tensor, k: torch.Tensor,
                  all_k: Optional[torch.Tensor], T: float, attn_mode: str,
                  attn_fns: Dict[str, Callable]
                  ) -> Tuple[torch.Tensor, QueueState]:
    """MoCoAtt: the attention modules act on q / k / queue INSIDE the step.
    `attn_fns` maps {'atts', 'atts_p', 'atts_n', 'atts_q', 'atts_k',
    'atts_queue'} to callables (CMOHeads.attn_fns).  k and the queue enter
    without gradient, but their transformed rows depend on the attention
    parameters, so gradients flow through every token."""
    bsz = q.shape[0]
    k = k.detach()
    queue = state.memory["memory"].detach()
    if attn_mode == "all":
        out = attn_fns["atts"](torch.cat([q, k, queue], 0))
        q, k, queue = out[:bsz], out[bsz:2 * bsz], out[2 * bsz:]
    elif attn_mode == "qk":
        out = attn_fns["atts"](torch.cat([q, k], 0))
        q, k = out[:bsz], out[bsz:]
    elif attn_mode == "dual":
        out_p = attn_fns["atts_p"](torch.cat([q, queue], 0))
        q, queue = out_p[:bsz], out_p[bsz:]
        out_n = attn_fns["atts_n"](torch.cat([k, queue], 0))
        k, queue = out_n[:bsz], out_n[bsz:]
    elif attn_mode == "dual2":
        q = attn_fns["atts_p"](torch.cat([q, k], 0))[:bsz]
        k = attn_fns["atts_n"](torch.cat([k, q], 0))[:bsz]
    elif attn_mode in ("self_qk", "self_qkv2"):
        q = attn_fns["atts_q"](q)
        k = attn_fns["atts_k"](k)
    else:  # the 'self' family: q / k / queue each through its own module
        q = attn_fns["atts_q"](q)
        k = attn_fns["atts_k"](k)
        queue = attn_fns["atts_queue"](queue)

    if attn_mode == "dual2":
        logits = pos_logits(q, k, T)
    else:
        logits = queue_logits(q, k, queue, T)
    all_k = k if all_k is None else all_k
    return logits, queue_update(state, {"memory": all_k})


def _dual_bank_update(state, k, k_t, all_k, all_k_t) -> QueueState:
    return queue_update(state, {
        "memory_s": k if all_k is None else all_k,
        "memory_t": k_t if all_k_t is None else all_k_t})


def step_moco_st(state: QueueState, q: torch.Tensor, k: torch.Tensor,
                 k_t: torch.Tensor, all_k: Optional[torch.Tensor],
                 all_k_t: Optional[torch.Tensor], T: float):
    """MoCoST: dual banks -> (logits_ss, logits_st, new_state)."""
    k, k_t = k.detach(), k_t.detach()
    qs = state.memory["memory_s"].detach()
    qt = state.memory["memory_t"].detach()
    logits_ss = queue_logits(q, k, qs, T)
    logits_st = queue_logits(q, k_t, qt, T)
    return logits_ss, logits_st, _dual_bank_update(state, k, k_t, all_k,
                                                   all_k_t)


def step_moco_sstt(state: QueueState, q: torch.Tensor, k: torch.Tensor,
                   q_t: Optional[torch.Tensor], k_t: torch.Tensor,
                   all_k: Optional[torch.Tensor],
                   all_k_t: Optional[torch.Tensor], T: float):
    """MoCoSSTT: dual banks x dual queries -> (logits_ss, logits_st
    [, logits_ts, logits_tt], new_state)."""
    k, k_t = k.detach(), k_t.detach()
    qs = state.memory["memory_s"].detach()
    qt = state.memory["memory_t"].detach()
    out = [queue_logits(q, k, qs, T), queue_logits(q, k_t, qt, T)]
    if q_t is not None:
        out.append(queue_logits(q_t, k, qs, T))
        out.append(queue_logits(q_t, k_t, qt, T))
    return (*out, _dual_bank_update(state, k, k_t, all_k, all_k_t))


# ------------------------------------------- model-sharded queue variants


class _GradPsum(torch.autograd.Function):
    """Identity forward; backward the model-pmean of the cotangent
    (queue.py:222-257).  The loss is replicated over the model ranks, the
    gathered logits' backward hands rank m MP times its block's cotangent,
    and rank m's product yields MP times its shard's part of dq: the
    pmean of those is the full dq on every rank."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.axis.pmean_([g])
        return g, None


class _GradDiv(torch.autograd.Function):
    """Identity forward; backward the cotangent / MP (queue.py:260-283):
    a bank block's rows are this rank's alone, so the MP identical
    cotangents the gather summed into them count once."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.size = axis.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def _grad_psum(x: torch.Tensor, axis) -> torch.Tensor:
    return _GradPsum.apply(x, axis)


def _grad_div(x: torch.Tensor, axis) -> torch.Tensor:
    return _GradDiv.apply(x, axis)


def sharded_queue_logits(q: torch.Tensor, k: torch.Tensor,
                         mem_local: torch.Tensor, T: float,
                         axis) -> torch.Tensor:
    """queue_logits with the bank's rows split over `axis` (the model
    axis): this rank's (B, K/MP) negatives, all-gathered along dim 1.  Each
    logit is one dot over D, so the values equal the whole bank's; only
    dq's shard-sum order differs (queue.py:299-312)."""
    pos = (q * k).sum(1, keepdim=True)
    neg = axis.all_gather_grad(_grad_psum(q, axis) @ mem_local.t(), 1)
    return torch.cat([pos, neg], dim=1) / T


def sharded_queue_logits_t(q: torch.Tensor, k: torch.Tensor,
                           mem_local_t: torch.Tensor, T: float,
                           axis) -> torch.Tensor:
    """sharded_queue_logits for a transformed bank block that carries a
    gradient (the ring attention's output rows, queue.py:286-296)."""
    pos = (q * k).sum(1, keepdim=True)
    neg = axis.all_gather_grad(
        _grad_psum(q, axis) @ _grad_div(mem_local_t, axis).t(), 1)
    return torch.cat([pos, neg], dim=1) / T


def sharded_queue_update(state: QueueState, new_keys: Dict[str, torch.Tensor],
                         axis) -> QueueState:
    """The circular write at (ptr + arange(n)) mod K restricted to this
    rank's rows (queue.py:315-340): `index_copy` of the keys whose target
    falls in [m*K/MP, (m+1)*K/MP).  The pointer advances by n mod K."""
    n = next(iter(new_keys.values())).shape[0]
    ksh = state.K
    K = ksh * axis.size
    dev = next(iter(state.memory.values())).device
    targets = (state.ptr + torch.arange(n, device=dev)) % K
    rows = targets - axis.index * ksh
    mine = (rows >= 0) & (rows < ksh)
    idx = rows[mine]
    mems = dict(state.memory)
    for name, keys in new_keys.items():
        mem = state.memory[name]
        mems[name] = mem.index_copy(
            0, idx, keys.detach()[mine].to(mem.dtype))
    return QueueState(memory=mems, ptr=(state.ptr + n) % K)


def step_moco_sharded(state: QueueState, q: torch.Tensor, k: torch.Tensor,
                      all_k: Optional[torch.Tensor], T: float,
                      axis) -> Tuple[torch.Tensor, QueueState]:
    """step_moco with the bank's rows split over the model axis."""
    k = k.detach()
    logits = sharded_queue_logits(q, k, state.memory["memory"].detach(), T,
                                  axis)
    all_k = k if all_k is None else all_k
    return logits, sharded_queue_update(state, {"memory": all_k}, axis)


def _dual_bank_update_sharded(state, k, k_t, all_k, all_k_t, axis):
    return sharded_queue_update(state, {
        "memory_s": k if all_k is None else all_k,
        "memory_t": k_t if all_k_t is None else all_k_t}, axis)


def step_moco_st_sharded(state: QueueState, q: torch.Tensor,
                         k: torch.Tensor, k_t: torch.Tensor,
                         all_k: Optional[torch.Tensor],
                         all_k_t: Optional[torch.Tensor], T: float, axis):
    """step_moco_st with both banks' rows split over the model axis."""
    k, k_t = k.detach(), k_t.detach()
    mem_s = state.memory["memory_s"].detach()
    mem_t = state.memory["memory_t"].detach()
    return (sharded_queue_logits(q, k, mem_s, T, axis),
            sharded_queue_logits(q, k_t, mem_t, T, axis),
            _dual_bank_update_sharded(state, k, k_t, all_k, all_k_t, axis))


def step_moco_sstt_sharded(state: QueueState, q: torch.Tensor,
                           k: torch.Tensor, q_t: Optional[torch.Tensor],
                           k_t: torch.Tensor, all_k: Optional[torch.Tensor],
                           all_k_t: Optional[torch.Tensor], T: float, axis):
    """step_moco_sstt (dual banks x dual queries) with split banks."""
    k, k_t = k.detach(), k_t.detach()
    mem_s = state.memory["memory_s"].detach()
    mem_t = state.memory["memory_t"].detach()
    out = [sharded_queue_logits(q, k, mem_s, T, axis),
           sharded_queue_logits(q, k_t, mem_t, T, axis)]
    if q_t is not None:
        out.append(sharded_queue_logits(q_t, k, mem_s, T, axis))
        out.append(sharded_queue_logits(q_t, k_t, mem_t, T, axis))
    return (*out, _dual_bank_update_sharded(state, k, k_t, all_k, all_k_t,
                                            axis))


def step_moco_att_sharded(state: QueueState, q: torch.Tensor,
                          k: torch.Tensor, all_k: Optional[torch.Tensor],
                          T: float, attn_mode: str,
                          attn_fns: Dict[str, Callable], axis,
                          ring_fns: Optional[Dict[str, Callable]] = None
                          ) -> Tuple[torch.Tensor, QueueState]:
    """step_moco_att with the bank's rows split over the model axis
    (queue.py:397-501).  The queue-consuming modes ('all', 'dual', the
    'self' family's atts_queue) attend over the whole bank, by one of two
    routes:

      ring (`ring_fns`, CMOHeads.ring_attn_fns): ring attention
          (ops/ring_attention.py); each rank keeps its (K/MP, D) rows, the
          key / value shards travel round the model ranks, and the
          transformed rows stay split into sharded_queue_logits_t.  No
          rank ever holds the whole bank, raw or transformed;
      all-gather (`ring_fns` None): the (K, D) bank gathered on every
          rank, the attention and logits of the replicated step.

    'qk' / 'self_qk' / 'self_qkv2' read the bank untransformed
    (sharded_queue_logits) and 'dual2' never reads it."""
    bsz = q.shape[0]
    k = k.detach()
    mem_local = state.memory["memory"].detach()
    consumes_queue = attn_mode not in ("qk", "self_qk", "self_qkv2", "dual2")
    use_ring = ring_fns is not None and consumes_queue
    queue = queue_loc = None
    if consumes_queue and not use_ring:
        queue = axis.all_gather(mem_local, 0)
    if attn_mode == "all":
        if use_ring:
            out_rep, queue_loc = ring_fns["atts"](torch.cat([q, k], 0),
                                                  mem_local)
            q, k = out_rep[:bsz], out_rep[bsz:]
        else:
            out = attn_fns["atts"](torch.cat([q, k, queue], 0))
            q, k, queue = out[:bsz], out[bsz:2 * bsz], out[2 * bsz:]
    elif attn_mode == "qk":
        out = attn_fns["atts"](torch.cat([q, k], 0))
        q, k = out[:bsz], out[bsz:]
    elif attn_mode == "dual":
        if use_ring:
            q, queue_loc = ring_fns["atts_p"](q, mem_local)
            k, queue_loc = ring_fns["atts_n"](k, queue_loc)
        else:
            out_p = attn_fns["atts_p"](torch.cat([q, queue], 0))
            q, queue = out_p[:bsz], out_p[bsz:]
            out_n = attn_fns["atts_n"](torch.cat([k, queue], 0))
            k, queue = out_n[:bsz], out_n[bsz:]
    elif attn_mode == "dual2":
        q = attn_fns["atts_p"](torch.cat([q, k], 0))[:bsz]
        k = attn_fns["atts_n"](torch.cat([k, q], 0))[:bsz]
    elif attn_mode in ("self_qk", "self_qkv2"):
        q = attn_fns["atts_q"](q)
        k = attn_fns["atts_k"](k)
    else:  # the 'self' family
        q = attn_fns["atts_q"](q)
        k = attn_fns["atts_k"](k)
        if use_ring:
            _, queue_loc = ring_fns["atts_queue"](q[:0], mem_local)
        else:
            queue = attn_fns["atts_queue"](queue)

    if attn_mode == "dual2":
        logits = pos_logits(q, k, T)
    elif attn_mode in ("qk", "self_qk", "self_qkv2"):
        logits = sharded_queue_logits(q, k, mem_local, T, axis)
    elif use_ring:
        logits = sharded_queue_logits_t(q, k, queue_loc, T, axis)
    else:
        logits = queue_logits(q, k, queue, T)
    all_k = k if all_k is None else all_k
    return logits, sharded_queue_update(state, {"memory": all_k}, axis)


def contrast_ce(logits: torch.Tensor) -> torch.Tensor:
    """CE over (K+1)-way contrast logits with the positive at column 0."""
    return -F.log_softmax(logits.float(), dim=1)[:, 0].mean()
