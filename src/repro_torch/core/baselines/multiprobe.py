"""Multi-Probe LSH [Lv et al., VLDB'07] — probing-sequence baseline.

One (or L) E2LSH hash tables; besides the query's own bucket, nearby
buckets are probed in the order of a perturbation-score heap (the
"generate-to-probe" paradigm, §3.1 PS).  Perturbation scores follow the
original paper: for delta = +1 the score is x_i(q)² where x_i is the
distance to the upper bucket boundary, for -1 it is (w - x_i)².

Table t's family is drawn on ``device`` from a generator seeded with
``seed * 131 + t``, as the reference seeds its draws, or taken from
``families`` (one :class:`BucketFamily` a table).
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ...device import resolve_device
from ..hashing import BucketFamily, hash_to_host


class MultiProbe:
    def __init__(self, data: np.ndarray, m: int = 6, w: float = 4.0,
                 n_tables: int = 4, n_probes: int = 64, seed: int = 0,
                 families: list[BucketFamily] | None = None,
                 device: str | torch.device = "cuda", **_):
        # m defaults to 6: a 15-fn compound key puts nearly every point in
        # its own bucket (the coarse-estimation weakness §3.2 describes);
        # the original Multi-Probe paper likewise uses short compound keys.
        self.data = np.asarray(data, np.float32)
        n, d = self.data.shape
        self.m, self.w = m, float(w)
        self.n_probes = n_probes
        dev = resolve_device(device)
        if families is not None and len(families) != n_tables:
            raise ValueError(f"{len(families)} families for {n_tables} tables")
        self.tables = []
        for t in range(n_tables):
            fam = (families[t] if families is not None
                   else BucketFamily.create(d, m, w, seed=seed * 131 + t, device=dev))
            keys = hash_to_host(fam, self.data)  # (n, m)
            buckets: dict[tuple, list[int]] = {}
            for i, key in enumerate(map(tuple, keys.tolist())):
                buckets.setdefault(key, []).append(i)
            self.tables.append((fam, buckets))

    def _probe_sequence(self, fam: BucketFamily, q: np.ndarray):
        """Yield bucket keys in increasing perturbation-score order."""
        raw = hash_to_host(fam, q[None], raw=True)[0]  # (m,)
        base = np.floor(raw).astype(np.int64)
        frac = raw - base  # distance to lower boundary, in w units
        # candidate single-coordinate perturbations with scores
        deltas = []
        for i in range(self.m):
            deltas.append(((1 - frac[i]) ** 2, i, +1))  # step up
            deltas.append((frac[i] ** 2, i, -1))  # step down
        deltas.sort()
        yield tuple(base.tolist())
        # heap over perturbation SETS (restricted to the classic scheme:
        # subsets of the sorted delta list, expand/shift)
        heap = [(deltas[0][0], (0,))]
        seen = set()
        while heap:
            score, subset = heapq.heappop(heap)
            if subset in seen:
                continue
            seen.add(subset)
            key = base.copy()
            coords = set()
            valid = True
            for j in subset:
                _, i, sign = deltas[j]
                if i in coords:
                    valid = False
                    break
                coords.add(i)
                key[i] += sign
            if valid:
                yield tuple(key.tolist())
            last = subset[-1]
            if last + 1 < len(deltas):
                heapq.heappush(
                    heap, (score + deltas[last + 1][0], subset + (last + 1,))
                )
                heapq.heappush(
                    heap,
                    (score - deltas[last][0] + deltas[last + 1][0],
                     subset[:-1] + (last + 1,)),
                )

    def query(self, q: np.ndarray, k: int):
        q = np.asarray(q, np.float32)
        cand: set[int] = set()
        for fam, buckets in self.tables:
            for j, key in enumerate(self._probe_sequence(fam, q)):
                if j >= self.n_probes:
                    break
                cand.update(buckets.get(key, ()))
        if not cand:
            return np.zeros(0, np.int64), np.zeros(0, np.float32), 0
        ids = np.fromiter(cand, dtype=np.int64)
        d = np.linalg.norm(self.data[ids] - q, axis=-1)
        order = np.argsort(d)[:k]
        return ids[order], d[order], ids.size
