"""CRD class-aware instance sampler (host side).

A copy of moma_tpu/data/sampler.py (`InstanceSampler`), numpy only, so
the port needs nothing of the JAX package: for each anchor, K negatives
drawn with replacement from the other classes ('exact': the positive in
column 0 is the anchor itself; 'relax': one drawn from its class).  The
draws come from numpy's RandomState, so both packages draw the same
`contrast_idx` from the same seed.
"""

from __future__ import annotations

import numpy as np


class InstanceSampler:
    def __init__(self, labels: np.ndarray, k: int, mode: str = "exact",
                 percent: float = 1.0, seed: int = 0):
        self.labels = np.asarray(labels)
        self.k = int(k)
        self.mode = mode
        self.n_data = len(self.labels)
        n_cls = int(self.labels.max()) + 1
        self.cls_positive = [np.where(self.labels == c)[0]
                             for c in range(n_cls)]
        self.cls_negative = [np.where(self.labels != c)[0]
                             for c in range(n_cls)]
        if percent < 1.0:
            rs = np.random.RandomState(seed)
            self.cls_negative = [rs.permutation(neg)[:int(len(neg) * percent)]
                                 for neg in self.cls_negative]
        self.rng = np.random.RandomState(seed + 1)

    def sample(self, idx: np.ndarray) -> np.ndarray:
        """idx (B,) anchor dataset indices -> (B, K+1) contrast indices,
        column 0 the positive."""
        B = idx.shape[0]
        out = np.empty((B, self.k + 1), dtype=np.int64)
        y = self.labels[idx]
        if self.mode == "exact":
            out[:, 0] = idx
        elif self.mode == "relax":
            for b in range(B):
                out[b, 0] = self.rng.choice(self.cls_positive[y[b]])
        else:
            raise ValueError(self.mode)
        for b in range(B):
            neg = self.cls_negative[y[b]]
            out[b, 1:] = neg[self.rng.randint(0, len(neg), size=self.k)]
        return out
