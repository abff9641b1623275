"""ACP-P [Cai et al., PAKDD'18] — 1-d projection closest-pair baseline.

Project to one dimension, sort, and verify pairs within a sliding
window of the sorted order; repeat over h independent projections.
The paper notes its distance estimation (a single projection) is
coarse, which is exactly what PM-LSH's χ²(m) estimator improves on.
"""
from __future__ import annotations

import numpy as np

from ..cp import _TopPairs


class ACPP:
    def __init__(self, data: np.ndarray, h: int = 5, range_val: int = 5,
                 seed: int = 0, **_):
        self.data = np.asarray(data, np.float32)
        self.h, self.range_val = h, range_val
        rng = np.random.default_rng(seed)
        d = self.data.shape[1]
        self.dirs = rng.normal(size=(d, h)).astype(np.float32)
        self.proj = self.data @ self.dirs  # (n, h)
        self.orders = np.argsort(self.proj, axis=0)

    def cp_query(self, k: int):
        top = _TopPairs(k)
        count = 0
        for t in range(self.h):
            order = self.orders[:, t]
            for off in range(1, self.range_val + 1):
                a, b = order[:-off], order[off:]
                d = np.linalg.norm(self.data[a] - self.data[b], axis=-1)
                count += d.size
                cut = top.bound
                sel = (np.where(d < cut)[0] if np.isfinite(cut)
                       else np.argsort(d)[: 4 * k])
                for i in sel:
                    top.push(float(d[i]), int(a[i]), int(b[i]))
        out = top.sorted()[:k]
        pairs = np.asarray([[i, j] for _, i, j in out], np.int64).reshape(-1, 2)
        dd = np.asarray([dv for dv, _, _ in out], np.float32)
        return pairs, dd, count
