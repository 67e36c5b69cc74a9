"""CRD, contrastive representation distillation.

Counterpart of moma_tpu/losses/crd.py: `CRDMemory` (:26), the two f32
memory banks with their lazy normalization constants Z, `contrast_scores`
(:47), `contrast_loss` (:91) and `crd_loss` (:103).  The JAX functions
return a new memory; here the step updates the banks in place, after
scoring against the gathered pre-update rows, which is the same order.
The negative indices come from the host (data/sampler.py), column 0 the
positive.

In a process group (core/mesh.py) each rank scores its own rows; Z is set
from the global batch's mean (the ranks' means averaged: equal shares),
and every rank writes the rows gathered from all ranks, in rank order,
into its banks, so the banks stay equal and each is the one-process
bank.  In one process (mesh._Replicated) both are the identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

EPS = 1e-7


@dataclass
class CRDMemory:
    """Student-side bank v1 and teacher-side bank v2, (n_data, feat_dim)
    f32, and their Z constants (0-dim f32, -1 until the first batch)."""

    v1: torch.Tensor
    v2: torch.Tensor
    z_v1: torch.Tensor
    z_v2: torch.Tensor

    @classmethod
    def create(cls, n_data: int, feat_dim: int, generator: torch.Generator,
               device=None) -> "CRDMemory":
        stdv = 1.0 / math.sqrt(feat_dim / 3)
        v1, v2 = (torch.empty(n_data, feat_dim).uniform_(
            -stdv, stdv, generator=generator).to(device) for _ in range(2))
        z = torch.full((), -1.0, device=device)
        return cls(v1=v1, v2=v2, z_v1=z, z_v2=z.clone())

    def state_dict(self) -> dict:
        return {"v1": self.v1, "v2": self.v2, "z_v1": self.z_v1,
                "z_v2": self.z_v2}

    def load_state_dict(self, saved: dict) -> None:
        with torch.no_grad():
            for k in ("v1", "v2", "z_v1", "z_v2"):
                getattr(self, k).copy_(saved[k])


def contrast_scores(mem: CRDMemory, f_s: torch.Tensor, f_t: torch.Tensor,
                    idx: torch.Tensor, contrast_idx: torch.Tensor,
                    nce_t: float, momentum: float, ax
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_v1, out_v2): exp scores against the PRE-update banks over
    (B, K+1) rows, divided by Z (set from the first batch, constant
    after); then rows `idx` of each bank move by momentum toward the batch
    embedding and are renormalized, in place.  `ax`: the data axis whose
    ranks' rows make the batch (module docstring)."""
    n_data = mem.v1.shape[0]
    cidx = contrast_idx.long()
    w_v1 = mem.v1[cidx]                      # (B, K+1, D), a copy
    w_v2 = mem.v2[cidx]
    out_v2 = torch.exp(torch.einsum("bkd,bd->bk", w_v1, f_t.float()) / nce_t)
    out_v1 = torch.exp(torch.einsum("bkd,bd->bk", w_v2, f_s.float()) / nce_t)
    with torch.no_grad():
        means = torch.stack([out_v1.mean(), out_v2.mean()])
        # every step, so no rank reads Z on the host to decide
        ax.pmean_([means])
        mem.z_v1.copy_(torch.where(mem.z_v1 < 0, means[0] * n_data,
                                   mem.z_v1))
        mem.z_v2.copy_(torch.where(mem.z_v2 < 0, means[1] * n_data,
                                   mem.z_v2))
        # the divisors are this step's Z: copies, so the in-place update
        # above cannot reach the graph
        z_v1, z_v2 = mem.z_v1.clone(), mem.z_v2.clone()
        idx, f_s, f_t = ax.gather(idx), ax.gather(f_s), ax.gather(f_t)
        rows_idx = idx.long()
        for bank, v in ((mem.v1, f_s), (mem.v2, f_t)):
            rows = bank[rows_idx] * momentum + v.float() * (1 - momentum)
            rows = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)
            bank.index_copy_(0, rows_idx, rows)
    return out_v1 / z_v1, out_v2 / z_v2


def contrast_loss(x: torch.Tensor, n_data: int) -> torch.Tensor:
    """Eq (18) NCE loss; column 0 is the positive (:91)."""
    B, m1 = x.shape
    m = m1 - 1
    Pn = 1.0 / n_data
    p_pos = x[:, 0]
    log_d1 = torch.log(p_pos / (p_pos + m * Pn + EPS))
    p_neg = x[:, 1:]
    log_d0 = torch.log((m * Pn) / (p_neg + m * Pn + EPS))
    return -(log_d1.sum() + log_d0.sum()) / B


def crd_loss(mem: CRDMemory, f_s: torch.Tensor, f_t: torch.Tensor,
             idx: torch.Tensor, contrast_idx: torch.Tensor, ax,
             nce_t: float = 0.07, momentum: float = 0.5) -> torch.Tensor:
    """The symmetric student / teacher NCE loss of one step (:103); the
    memory is updated in place.  A mean over the rows: on ranks, their
    average is the global batch's loss."""
    n_data = mem.v1.shape[0]
    out_v1, out_v2 = contrast_scores(mem, f_s, f_t, idx, contrast_idx,
                                     nce_t, momentum, ax)
    return contrast_loss(out_v1, n_data) + contrast_loss(out_v2, n_data)
