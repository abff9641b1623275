"""MkCP / GMA [Gao et al., VLDBJ'15] — M-tree closest pairs in the
ORIGINAL space (no dimensionality reduction — hence its degeneration on
high-d data, paper §7.3).  Grouping (N-consider) trades accuracy for
time: only the N nearest sibling subtrees of each node are paired."""
from __future__ import annotations

import heapq

import numpy as np

from ..cp import _TopPairs, _mindist, _pairwise
from ..pmtree import build_bulk


class MkCP:
    def __init__(self, data: np.ndarray, capacity: int = 16, n_consider: int = 2,
                 seed: int = 0, **_):
        self.data = np.asarray(data, np.float32)
        # M-tree on the ORIGINAL space = PM-tree with zero pivots
        self.tree = build_bulk(self.data, capacity=capacity, fanout=2,
                               n_pivots=1, seed=seed)
        self.n_consider = n_consider

    def cp_query(self, k: int):
        t = self.tree
        top = _TopPairs(k)
        count = 0
        # leaf self-joins
        for e in np.where(t.is_leaf)[0]:
            s, c = int(t.leaf_start[e]), int(t.leaf_count[e])
            if c < 2:
                continue
            dmat = _pairwise(t.points[s : s + c])
            iu = np.triu_indices(c, 1)
            count += iu[0].size
            for a, b, dv in zip(iu[0], iu[1], dmat[iu]):
                top.push(float(dv), s + int(a), s + int(b))
        # best-first over node pairs with N-consider grouping
        pq = [(0.0, 0, 0)]
        visited = set()
        while pq:
            md, e1, e2 = heapq.heappop(pq)
            if md > top.bound:
                break
            l1, l2 = t.child_count[e1] == 0, t.child_count[e2] == 0
            if l1 and l2:
                if e1 == e2:
                    continue
                s1, c1 = int(t.leaf_start[e1]), int(t.leaf_count[e1])
                s2, c2 = int(t.leaf_start[e2]), int(t.leaf_count[e2])
                dmat = _pairwise(t.points[s1 : s1 + c1], t.points[s2 : s2 + c2])
                count += c1 * c2
                for a in range(c1):
                    for b in range(c2):
                        top.push(float(dmat[a, b]), s1 + a, s2 + b)
                continue

            def kids(e, is_leaf):
                if is_leaf:
                    return [e]
                cs, cc = int(t.child_start[e]), int(t.child_count[e])
                return list(range(cs, cs + cc))

            ka, kb = kids(e1, l1), kids(e2, l2)
            # N-consider: for each child of e1, keep only the n nearest
            # children of e2 (the GMA grouping approximation)
            for a in ka:
                scored = sorted(
                    ((_mindist(t, a, b), b) for b in kb if not (e1 == e2 and b < a))
                )[: self.n_consider]
                for md2, b in scored:
                    key = (a, b) if a <= b else (b, a)
                    if key not in visited:
                        visited.add(key)
                        heapq.heappush(pq, (md2, *key))
        out = top.sorted()[:k]
        pairs = np.asarray(
            [[t.perm[i], t.perm[j]] for _, i, j in out], np.int64
        ).reshape(-1, 2)
        dd = np.asarray([dv for dv, _, _ in out], np.float32)
        return pairs, dd, count
