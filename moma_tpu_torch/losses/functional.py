"""Stateless losses used by the MoMA step.

Counterpart of moma_tpu/losses/functional.py: `cross_entropy` (:21),
`kd_kl` (:31) and `l2_normalize` (:88).  The rest of the KD loss zoo is
not ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy (f32)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def kd_kl(logits_s: torch.Tensor, logits_t: torch.Tensor,
          T: float = 4.0) -> torch.Tensor:
    """Hinton KD: T^2-scaled KL(p_t || p_s), batch-mean."""
    logp_s = F.log_softmax(logits_s.float() / T, dim=-1)
    logp_t = F.log_softmax(logits_t.float() / T, dim=-1)
    p_t = torch.exp(logp_t)
    kl = (p_t * (logp_t - logp_s)).sum(-1)
    return kl.mean() * (T ** 2)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (torch F.normalize semantics)."""
    n = torch.sqrt((x * x).sum(dim, keepdim=True))
    return x / torch.clamp(n, min=eps)
