"""QALSH [Huang et al., PVLDB'15] — query-aware radius-enlargement LSH.

m one-dimensional projections, each indexed by a sorted array (the
B⁺-tree equivalent for in-memory use).  A query expands a width-w
window on every projection ("virtual rehashing": w, cw, c²w, ...) and
counts collisions; points with ≥ l collisions become candidates, until
βn candidates are verified or k good results are found.
"""
from __future__ import annotations

import math

import numpy as np


class QALSH:
    def __init__(self, data: np.ndarray, c: float = 1.5, m: int = 15,
                 w: float = 4.0, beta: float | None = None,
                 delta: float = 1 / math.e, seed: int = 0, **_):
        self.data = np.asarray(data, np.float32)
        n, d = self.data.shape
        self.c, self.w, self.m = float(c), float(w), m
        self.beta = beta if beta is not None else max(100.0 / n, 0.01)
        rng = np.random.default_rng(seed)
        self.a = rng.normal(size=(d, m)).astype(np.float32)
        self.proj = self.data @ self.a  # (n, m)
        self.order = np.argsort(self.proj, axis=0)  # sorted ids per proj
        self.sorted_vals = np.take_along_axis(self.proj, self.order, axis=0)
        # collision threshold: majority of hash functions (paper: l = α·m)
        self.l = max(1, int(0.5 * m))

    def query(self, q: np.ndarray, k: int):
        q = np.asarray(q, np.float32)
        qp = q @ self.a  # (m,)
        n = self.data.shape[0]
        target = int(self.beta * n) + k
        counts = np.zeros(n, np.int16)
        lo = np.empty(self.m, np.int64)
        hi = np.empty(self.m, np.int64)
        for i in range(self.m):
            lo[i] = np.searchsorted(self.sorted_vals[:, i], qp[i])
            hi[i] = lo[i]
        r = self.w / 2
        verified: dict[int, float] = {}
        rounds = 0
        while True:
            rounds += 1
            newly = []
            for i in range(self.m):
                lo_v, hi_v = qp[i] - r, qp[i] + r
                new_lo = np.searchsorted(self.sorted_vals[:, i], lo_v)
                new_hi = np.searchsorted(self.sorted_vals[:, i], hi_v)
                if new_lo < lo[i]:
                    ids = self.order[new_lo : lo[i], i]
                    counts[ids] += 1
                    newly.append(ids)
                    lo[i] = new_lo
                if new_hi > hi[i]:
                    ids = self.order[hi[i] : new_hi, i]
                    counts[ids] += 1
                    newly.append(ids)
                    hi[i] = new_hi
            if newly:
                cand = np.unique(np.concatenate(newly))
                cand = cand[counts[cand] >= self.l]
                todo = [int(x) for x in cand if x not in verified]
                if todo:
                    ids = np.asarray(todo)
                    dd = np.linalg.norm(self.data[ids] - q, axis=-1)
                    verified.update(zip(todo, dd.tolist()))
            if len(verified) >= target:
                break
            if len(verified) >= k:
                dists = np.fromiter(verified.values(), float)
                if (np.sort(dists)[:k] <= self.c * r).sum() >= k:
                    break
            if (np.asarray(lo) == 0).all() and (np.asarray(hi) == n).all():
                break
            r *= self.c
        ids = np.fromiter(verified.keys(), np.int64)
        dd = np.fromiter(verified.values(), np.float64)
        o = np.argsort(dd)[:k]
        return ids[o], dd[o].astype(np.float32), len(verified)
