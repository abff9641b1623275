"""LScan (paper §7.1): linear scan over a random fraction of the data."""
from __future__ import annotations

import numpy as np


class LScan:
    def __init__(self, data: np.ndarray, fraction: float = 0.7, seed: int = 0,
                 **_):
        self.data = np.asarray(data, np.float32)
        rng = np.random.default_rng(seed)
        n = self.data.shape[0]
        self.subset = rng.permutation(n)[: max(1, int(fraction * n))]

    def query(self, q: np.ndarray, k: int):
        sub = self.data[self.subset]
        d = np.linalg.norm(sub - np.asarray(q, np.float32), axis=-1)
        order = np.argsort(d)[:k]
        return self.subset[order], d[order], self.subset.size
