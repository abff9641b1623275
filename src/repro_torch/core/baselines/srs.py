"""SRS [Sun et al., PVLDB'14] and R-LSH — metric-indexing baselines.

SRS projects to m dims and runs INCREMENTAL exact NN in the projected
space (here via an STR-bulk-loaded R-tree with a best-first heap —
the in-memory equivalent of their R-tree/cover-tree variants),
verifying original distances until the early-termination test or the
max-candidate budget T fires.

R-LSH = PM-LSH with the PM-tree swapped for the same R-tree (paper
§7.1): range queries with radius t·r, enlarging r ← c·r.

Both project on ``device`` as the PM-tree index does
(``hashing.host_projection``): A drawn from ``seed``, or ``a`` given,
and ``projected`` taken as given when passed.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from ...device import resolve_device
from ..estimator import chi2_cdf, select_rmin, solve_parameters
from ..hashing import host_projection, project_to_host


class _RTree:
    """STR bulk-loaded R-tree over m-dim points with best-first NN and
    range queries.  Nodes stored flat: (mbr_lo, mbr_hi, children|points)."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        self.points = points
        n, m = points.shape
        # STR: sort by first dim into slabs, then by second dim, etc.
        ids = np.arange(n)
        leaves = self._str_pack(ids, leaf_size)
        self.nodes: list[dict] = []
        level = []
        for leaf_ids in leaves:
            pts = points[leaf_ids]
            self.nodes.append(
                {"lo": pts.min(0), "hi": pts.max(0), "points": leaf_ids}
            )
            level.append(len(self.nodes) - 1)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), leaf_size):
                group = level[i : i + leaf_size]
                lo = np.min([self.nodes[g]["lo"] for g in group], axis=0)
                hi = np.max([self.nodes[g]["hi"] for g in group], axis=0)
                self.nodes.append({"lo": lo, "hi": hi, "children": group})
                nxt.append(len(self.nodes) - 1)
            level = nxt
        self.root = level[0]

    def _str_pack(self, ids: np.ndarray, leaf_size: int) -> list[np.ndarray]:
        pts = self.points[ids]
        n, m = pts.shape
        n_leaves = max(1, -(-n // leaf_size))
        s = max(1, int(math.ceil(n_leaves ** (1 / min(m, 2)))))
        order = ids[np.argsort(pts[:, 0], kind="stable")]
        slabs = np.array_split(order, s)
        out: list[np.ndarray] = []
        for slab in slabs:
            if slab.size == 0:
                continue
            o2 = slab[np.argsort(self.points[slab, 1 % m], kind="stable")]
            out.extend(
                o2[j : j + leaf_size] for j in range(0, o2.size, leaf_size)
            )
        return out

    def _mindist(self, node: dict, q: np.ndarray) -> float:
        diff = np.maximum(node["lo"] - q, 0) + np.maximum(q - node["hi"], 0)
        return float(np.sqrt((diff**2).sum()))

    def inc_nn(self, q: np.ndarray):
        """Yield (projected_distance, point_id) in ascending order."""
        heap: list[tuple[float, int, int]] = [
            (self._mindist(self.nodes[self.root], q), 0, self.root)
        ]
        # entries: (dist, is_point, id)
        while heap:
            dist, is_point, ident = heapq.heappop(heap)
            if is_point:
                yield dist, ident
                continue
            node = self.nodes[ident]
            if "points" in node:
                for pid in node["points"]:
                    d = float(np.linalg.norm(self.points[pid] - q))
                    heapq.heappush(heap, (d, 1, int(pid)))
            else:
                for ch in node["children"]:
                    heapq.heappush(heap, (self._mindist(self.nodes[ch], q), 0, ch))

    def range_query(self, q: np.ndarray, radius: float) -> np.ndarray:
        out = []
        stack = [self.root]
        while stack:
            node = self.nodes[stack.pop()]
            if self._mindist(node, q) > radius:
                continue
            if "points" in node:
                pts = self.points[node["points"]]
                d = np.linalg.norm(pts - q, axis=-1)
                out.extend(np.asarray(node["points"])[d <= radius].tolist())
            else:
                stack.extend(node["children"])
        return np.asarray(out, np.int64)


class SRS:
    def __init__(self, data: np.ndarray, c: float = 1.5, m: int = 15,
                 T_frac: float = 0.4010, p_tau: float = 0.8107, seed: int = 0,
                 a: np.ndarray | None = None, projected: np.ndarray | None = None,
                 device: str | torch.device = "cuda", **_):
        self.data = np.asarray(data, np.float32)
        self.c = float(c)
        self.fam, self.proj = host_projection(self.data, m, seed=seed, a=a,
                                              projected=projected,
                                              device=resolve_device(device))
        self.tree = _RTree(self.proj)
        self.T_frac, self.p_tau, self.m = T_frac, p_tau, m
        self._chi2cdf = lambda x: chi2_cdf(x, m)

    def query(self, q: np.ndarray, k: int):
        q = np.asarray(q, np.float32)
        qp = project_to_host(self.fam, q[None])[0]
        T = max(k, int(self.T_frac * self.data.shape[0]))
        best: list[tuple[float, int]] = []  # max-heap via neg
        count = 0
        for proj_d, pid in self.tree.inc_nn(qp):
            if count >= T:
                break
            count += 1
            d = float(np.linalg.norm(self.data[pid] - q))
            heapq.heappush(best, (-d, pid))
            if len(best) > k:
                heapq.heappop(best)
            # early termination: any remaining point has projected distance
            # ≥ proj_d; if its original distance were ≤ d_k/c it would have
            # Pr[proj ≥ proj_d] = 1 - CDF_χ²(m)(proj_d²c²/d_k²).  Stop once
            # that mass drops below 1 - p_τ.  (Lemma 1: proj²/orig² ~ χ²(m).)
            if len(best) == k and proj_d > 0:
                dk = -best[0][0]
                stat = self._chi2cdf(
                    proj_d**2 * self.c**2 / max(dk, 1e-9) ** 2
                )
                if stat > self.p_tau:
                    break
        out = sorted((-d, i) for d, i in best)
        ids = np.asarray([i for _, i in out], np.int64)
        dd = np.asarray([d for d, _ in out], np.float32)
        return ids, dd, count


class RLSH:
    """PM-LSH's Algorithm 2 with an R-tree instead of the PM-tree."""

    def __init__(self, data: np.ndarray, c: float = 1.5, m: int = 15,
                 beta: float | None = None, seed: int = 0,
                 a: np.ndarray | None = None, projected: np.ndarray | None = None,
                 device: str | torch.device = "cuda", **_):
        self.data = np.asarray(data, np.float32)
        self.fam, self.proj = host_projection(self.data, m, seed=seed, a=a,
                                              projected=projected,
                                              device=resolve_device(device))
        self.tree = _RTree(self.proj)
        self.params = solve_parameters(c, m=m, beta=beta)
        self._rmin = lambda k: select_rmin(self.data, self.params.beta, k)

    def query(self, q: np.ndarray, k: int):
        q = np.asarray(q, np.float32)
        qp = project_to_host(self.fam, q[None])[0]
        c, t, beta = self.params.c, self.params.t, self.params.beta
        n = self.data.shape[0]
        r = self._rmin(k)
        verified: dict[int, float] = {}
        while True:
            if len(verified) >= k:
                dists = np.fromiter(verified.values(), float)
                if (np.sort(dists)[:k] <= c * r).sum() >= k:
                    break
            ids = self.tree.range_query(qp, t * r)
            todo = [int(i) for i in ids if i not in verified]
            if todo:
                arr = np.asarray(todo)
                dd = np.linalg.norm(self.data[arr] - q, axis=-1)
                verified.update(zip(todo, dd.tolist()))
            if len(verified) >= beta * n + k:
                break
            r *= c
        ids = np.fromiter(verified.keys(), np.int64)
        dd = np.fromiter(verified.values(), np.float64)
        o = np.argsort(dd)[:k]
        return ids[o], dd[o].astype(np.float32), len(verified)
