"""LSB-tree [Tao et al., TODS'10] — Z-order bucketing baseline (NN + CP).

Compound LSH hash → m-dim integer grid → Z-curve value → sorted array
(the B-tree).  NN probes buckets around the query's Z-value; CP pairs
points with equal/adjacent Z-values.  L trees boost recall (the paper
uses L = O(√n); we keep L configurable).

Tree t's family is drawn on ``device`` from a generator seeded with
``seed * 977 + t``, as the reference seeds its draws, or taken from
``families`` (one :class:`BucketFamily` a tree)."""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ..cp import _TopPairs
from ..hashing import BucketFamily, hash_to_host


def _interleave(keys: np.ndarray, bits: int = 8) -> np.ndarray:
    """Z-order value of non-negative int coords (n, m) → (n,) uint64."""
    n, m = keys.shape
    out = np.zeros(n, np.uint64)
    for b in range(bits):
        for i in range(m):
            bit = (keys[:, i] >> b) & 1
            out |= bit.astype(np.uint64) << np.uint64(b * m + i)
    return out


class LSBTree:
    def __init__(self, data: np.ndarray, m: int = 5, w: float = 4.0,
                 n_trees: int = 8, seed: int = 0,
                 families: list[BucketFamily] | None = None,
                 device: str | torch.device = "cuda", **_):
        # m=5 keeps Z-order locality meaningful (interleaving degrades
        # exponentially with dimensionality — LSB picks small m by theory)
        self.data = np.asarray(data, np.float32)
        n, d = self.data.shape
        dev = resolve_device(device)
        if families is not None and len(families) != n_trees:
            raise ValueError(f"{len(families)} families for {n_trees} trees")
        self.trees = []
        for t in range(n_trees):
            fam = (families[t] if families is not None
                   else BucketFamily.create(d, m, w, seed=seed * 977 + t, device=dev))
            keys = hash_to_host(fam, self.data)
            base = keys.min(axis=0)
            z = _interleave(np.clip(keys - base, 0, 255))
            order = np.argsort(z, kind="stable")
            self.trees.append((fam, base, z[order], order))

    def query(self, q: np.ndarray, k: int, probe: int = 128):
        q = np.asarray(q, np.float32)
        cand: set[int] = set()
        for fam, base, z_sorted, order in self.trees:
            keys = hash_to_host(fam, q[None])[0] - base
            zq = _interleave(np.clip(keys, 0, 255)[None])[0]
            pos = np.searchsorted(z_sorted, zq)
            lo, hi = max(0, pos - probe // 2), min(z_sorted.size, pos + probe // 2)
            cand.update(order[lo:hi].tolist())
        if not cand:
            return np.zeros(0, np.int64), np.zeros(0, np.float32), 0
        ids = np.fromiter(cand, np.int64)
        d = np.linalg.norm(self.data[ids] - q, axis=-1)
        o = np.argsort(d)[:k]
        return ids[o], d[o], ids.size

    def cp_query(self, k: int, window: int = 32):
        """Closest pairs: verify pairs within a Z-order sliding window."""
        top = _TopPairs(k)
        count = 0
        for fam, base, z_sorted, order in self.trees:
            n = order.size
            for off in range(1, window + 1):
                a = order[:-off] if off else order
                b = order[off:]
                d = np.linalg.norm(self.data[a] - self.data[b], axis=-1)
                count += d.size
                cut = top.bound
                sel = np.where(d < cut)[0] if np.isfinite(cut) else np.argsort(
                    d
                )[: 4 * k]
                for i in sel:
                    top.push(float(d[i]), int(a[i]), int(b[i]))
        out = top.sorted()[:k]
        pairs = np.asarray([[i, j] for _, i, j in out], np.int64).reshape(-1, 2)
        dd = np.asarray([dv for dv, _, _ in out], np.float32)
        return pairs, dd, count
