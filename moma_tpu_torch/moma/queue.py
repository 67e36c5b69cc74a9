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
one from a torch.Generator for standalone runs.  The `*_sharded` variants
(:206-501) wait for the multi-GPU slice.
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


def contrast_ce(logits: torch.Tensor) -> torch.Tensor:
    """CE over (K+1)-way contrast logits with the positive at column 0."""
    return -F.log_softmax(logits.float(), dim=1)[:, 0].mean()
