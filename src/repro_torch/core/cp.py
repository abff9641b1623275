"""Closest-pair query processing (paper §6).

* Algorithm 3 — branch-and-bound over PM-tree node pairs in best-first
  Mindist order (Eq. 11: max of the pivot-ring lower bounds and the
  center-ball bound).  Kept as the reference; the paper itself shows it
  degenerates (>70% of node pairs have Mindist = 0).
* Algorithms 4-5 — radius filtering: leaf self-joins give an upper
  bound ``ub`` on the k-th pair distance; only subtrees with covering
  radius < γ·t·ub can hold a projected pair within t·ub, so FindLCA
  collects exactly those nodes, examined in ascending radius order.
* γ calibration (§6.3, Fig. 7): empirical pdf of
  γ_pair = (LCA covering radius) / (projected pair distance), take the
  Pr(γ) = 85% quantile.

Pair verification (original-space distances) is the dense hot spot and
is vectorized.  This module is the paper-faithful HOST index, the
counterpart of ``repro.core.cp``: only the projection of the data runs
on the index's device; the tree, the branch-and-bound, the radius
filter and their counters are the reference's numpy.  The engine on the
card (``core/cp_fused.py`` + the pair_join kernel) re-expresses the
Algorithm-4 radius filter as tile masking.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from ..device import resolve_device
from .ann import host_rows
from .estimator import PMLSHParams, solve_parameters
from .hashing import host_projection
from .pmtree import FlatPMTree, build_bulk, build_insert

__all__ = ["PMLSH_CP", "CpResult", "calibrate_gamma"]


@dataclasses.dataclass
class CpResult:
    pairs: np.ndarray  # (k, 2) int32 original ids
    distances: np.ndarray  # (k,) float32 original distances
    pairs_verified: int  # original-space pair distance computations
    nodes_examined: int


def _mindist(tree: FlatPMTree, e1: int, e2: int) -> float:
    """Eq. 11: lower bound on any cross pair distance between nodes."""
    ring = np.maximum(
        tree.hr_min[e1] - tree.hr_max[e2], tree.hr_min[e2] - tree.hr_max[e1]
    )
    lb_ring = float(np.max(np.maximum(ring, 0.0)))
    d = float(np.linalg.norm(tree.centers[e1] - tree.centers[e2]))
    lb_ball = d - float(tree.radii[e1]) - float(tree.radii[e2])
    return max(lb_ring, lb_ball, 0.0)


def _pairwise(a: np.ndarray, b: np.ndarray | None = None) -> np.ndarray:
    if b is None:
        d = np.linalg.norm(a[:, None, :] - a[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d
    return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)


class _TopPairs:
    """Bounded max-heap of (distance, i, j) keeping the k smallest."""

    def __init__(self, k: int):
        self.k = k
        self.heap: list[tuple[float, int, int]] = []  # (-dist, i, j)
        self.seen: set[tuple[int, int]] = set()

    def push(self, dist: float, i: int, j: int):
        key = (i, j) if i < j else (j, i)
        if key in self.seen:
            return
        if len(self.heap) < self.k:
            self.seen.add(key)
            heapq.heappush(self.heap, (-dist, *key))
        elif dist < -self.heap[0][0]:
            self.seen.add(key)
            _, oi, oj = heapq.heapreplace(self.heap, (-dist, *key))
            self.seen.discard((oi, oj))

    @property
    def bound(self) -> float:
        return -self.heap[0][0] if len(self.heap) >= self.k else np.inf

    def sorted(self) -> list[tuple[float, int, int]]:
        return sorted((-d, i, j) for d, i, j in self.heap)


class PMLSH_CP:
    """PM-LSH closest-pair index (projection + PM-tree, paper §6).

    A is drawn from ``seed`` on ``device`` unless ``a`` (d, m) is given;
    ``projected`` (n, m) is taken as given when passed."""

    def __init__(
        self,
        data,
        *,
        m: int = 15,
        s: int = 5,
        capacity: int = 16,
        fanout: int = 2,
        c: float = 4.0,
        alpha1: float = 1.0 / math.e,
        pr_gamma: float = 0.85,
        seed: int = 0,
        builder: str = "bulk",
        promote: str = "m_RAD",
        a: np.ndarray | None = None,
        projected: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        dev = resolve_device(device)
        self.family, self.projected = host_projection(
            data, m, seed=seed, a=a, projected=projected, device=dev)
        self.data = host_rows(data)
        self.n, self.d = self.data.shape
        self.params: PMLSHParams = solve_parameters(c, m=m, alpha1=alpha1)
        build = build_bulk if builder == "bulk" else build_insert
        # low fanout → graded radius spectrum, which radius filtering needs
        kw = {"fanout": fanout} if builder == "bulk" else {"promote": promote}
        self.tree: FlatPMTree = build(
            self.projected, capacity=capacity, n_pivots=s, seed=seed, **kw
        )
        self.gamma = calibrate_gamma(self.tree, pr=pr_gamma)

    # ------------------------------------------------------------------
    # shared helpers
    # ------------------------------------------------------------------

    def _leaves(self) -> np.ndarray:
        return np.where(self.tree.is_leaf)[0]

    def _leaf_selfjoin(self, top: _TopPairs, *, space: str) -> int:
        """Self-join every leaf; update `top` with ORIGINAL distances when
        space='original' (Alg. 4) or PROJECTED (Alg. 3).  Returns #pairs."""
        t = self.tree
        count = 0
        pts = t.points if space == "projected" else None
        for e in self._leaves():
            s0, cnt = int(t.leaf_start[e]), int(t.leaf_count[e])
            if cnt < 2:
                continue
            slots = np.arange(s0, s0 + cnt)
            if space == "projected":
                dmat = _pairwise(pts[s0 : s0 + cnt])
            else:
                ids = t.perm[slots]
                dmat = _pairwise(self.data[ids])
            count += cnt * (cnt - 1) // 2
            iu = np.triu_indices(cnt, k=1)
            for a, b, dist in zip(iu[0], iu[1], dmat[iu]):
                top.push(float(dist), int(slots[a]), int(slots[b]))
        return count

    def _subtree_slots(self, e: int) -> np.ndarray:
        """All point slots under node e (leaf ranges are contiguous per
        subtree thanks to the BFS leaf-ordering of the builder)."""
        t = self.tree
        stack, out = [e], []
        while stack:
            x = stack.pop()
            if t.child_count[x] == 0:
                out.append((int(t.leaf_start[x]), int(t.leaf_count[x])))
            else:
                cs, cc = int(t.child_start[x]), int(t.child_count[x])
                stack.extend(range(cs, cs + cc))
        return np.concatenate([np.arange(s, s + c) for s, c in out])

    def _verify_slots_pairs(self, top: _TopPairs, cand: list[tuple[int, int]]):
        """Compute original distances for candidate slot pairs (batched)."""
        if not cand:
            return 0
        arr = np.asarray(cand, dtype=np.int64)
        ids1 = self.tree.perm[arr[:, 0]]
        ids2 = self.tree.perm[arr[:, 1]]
        d = np.linalg.norm(self.data[ids1] - self.data[ids2], axis=-1)
        for (s1, s2), dist in zip(cand, d.tolist()):
            top.push(dist, s1, s2)
        return len(cand)

    def _emit(self, top: _TopPairs, verified: int, nodes: int, k: int) -> CpResult:
        out = top.sorted()[:k]
        pairs = np.asarray(
            [[self.tree.perm[i], self.tree.perm[j]] for _, i, j in out], dtype=np.int32
        ).reshape(-1, 2)
        dists = np.asarray([d for d, _, _ in out], dtype=np.float32)
        return CpResult(pairs=pairs, distances=dists, pairs_verified=verified,
                        nodes_examined=nodes)

    # ------------------------------------------------------------------
    # Algorithm 3: branch and bound (projected-space top-T, then verify)
    # ------------------------------------------------------------------

    def cp_query_bb(self, k: int = 1, T: int | None = None) -> CpResult:
        t = self.tree
        if T is None:
            T = self._default_T(k)
        # step 1: leaf self-joins in PROJECTED space seed d_T
        topP = _TopPairs(T)
        self._leaf_selfjoin(topP, space="projected")
        nodes = 0
        # step 2-3: best-first over node pairs
        pq: list[tuple[float, int, int]] = [(0.0, 0, 0)]
        visited = set()
        while pq:
            md, e1, e2 = heapq.heappop(pq)
            if md > topP.bound:
                break
            nodes += 1
            leaf1 = t.child_count[e1] == 0
            leaf2 = t.child_count[e2] == 0
            if leaf1 and leaf2:
                if e1 == e2:
                    continue  # self-joined already
                s1, c1 = int(t.leaf_start[e1]), int(t.leaf_count[e1])
                s2, c2 = int(t.leaf_start[e2]), int(t.leaf_count[e2])
                dmat = _pairwise(t.points[s1 : s1 + c1], t.points[s2 : s2 + c2])
                for a in range(c1):
                    for b in range(c2):
                        topP.push(float(dmat[a, b]), s1 + a, s2 + b)
            else:
                # expand the non-leaf side(s); robust to unbalanced trees
                def kids(e, is_leaf):
                    if is_leaf:
                        return [e]
                    cs, cc = int(t.child_start[e]), int(t.child_count[e])
                    return list(range(cs, cs + cc))

                ka, kb = kids(e1, leaf1), kids(e2, leaf2)
                for a in ka:
                    for b in kb:
                        if e1 == e2 and b < a:
                            continue  # unordered pairs once
                        key = (a, b) if a <= b else (b, a)
                        if key in visited:
                            continue
                        visited.add(key)
                        heapq.heappush(pq, (_mindist(t, a, b), *key))
        # step 4: verify original distances of the projected top-T
        topO = _TopPairs(k)
        cand = [(i, j) for _, i, j in topP.sorted()]
        verified = self._verify_slots_pairs(topO, cand)
        return self._emit(topO, verified, nodes, k)

    # ------------------------------------------------------------------
    # Algorithms 4-5: radius filtering
    # ------------------------------------------------------------------

    def _default_T(self, k: int) -> int:
        # §6.3 analysis: T = α2·n(n-1) + k (paper's CP setting)
        return int(min(self.params.alpha2 * self.n * (self.n - 1) + k,
                       self.n * (self.n - 1) // 2))

    def cp_query(self, k: int = 1, T: int | None = None) -> CpResult:
        """Radius-filtering (c,k)-ACP (Algorithm 4)."""
        t = self.tree
        tt = self.params.t
        if T is None:
            T = self._default_T(k)
        top = _TopPairs(k)
        # 1. self-join all leaves, verify in ORIGINAL space → ub
        count = self._leaf_selfjoin(top, space="original")
        ub = top.bound
        if not np.isfinite(ub):  # degenerate: every leaf has < 2 points
            ub = float(np.inf)
        # 2-3. FindLCA: maximal nodes with radius < R = γ·t·ub
        R = self.gamma * tt * ub
        A: list[int] = []
        stack = [0]
        while stack:
            e = stack.pop()
            if t.child_count[e] == 0:
                continue  # leaves already self-joined
            if t.radii[e] < R:
                A.append(e)
            else:
                cs, cc = int(t.child_start[e]), int(t.child_count[e])
                stack.extend(range(cs, cs + cc))
        # 4. ascending radius order
        A.sort(key=lambda e: float(t.radii[e]))
        nodes = 0
        # 5. examine: projected pairs < t·ub → verify original distance
        for e in A:
            nodes += 1
            slots = self._subtree_slots(e)
            if slots.size < 2:
                continue
            proj = t.points[slots]
            dmat = _pairwise(proj)
            iu = np.triu_indices(slots.size, k=1)
            dv = dmat[iu]
            # skip pairs already verified during leaf self-joins
            same_leaf = t.point_leaf[slots[iu[0]]] == t.point_leaf[slots[iu[1]]]
            sel = (dv < tt * ub) & ~same_leaf
            cand = [
                (int(slots[a]), int(slots[b]))
                for a, b in zip(iu[0][sel], iu[1][sel])
            ]
            count += self._verify_slots_pairs(top, cand)
            ub = min(ub, top.bound)
            if count > T:
                break
        return self._emit(top, count, nodes, k)

    # ------------------------------------------------------------------
    # exact reference
    # ------------------------------------------------------------------

    def exact_cp(self, k: int = 1, block: int = 2048) -> CpResult:
        """Blocked nested-loop join (NLJ) — exact k closest pairs."""
        top = _TopPairs(k)
        n = self.n
        count = 0
        for i0 in range(0, n, block):
            a = self.data[i0 : i0 + block]
            for j0 in range(i0, n, block):
                b = self.data[j0 : j0 + block]
                d = _pairwise(a, b)
                if i0 == j0:
                    d = np.triu(d, k=1) + np.tril(np.full_like(d, np.inf))
                count += int(np.isfinite(d).sum())
                flat = np.argsort(d, axis=None)[: 4 * k]
                for f in flat:
                    ai, bj = np.unravel_index(f, d.shape)
                    if np.isfinite(d[ai, bj]):
                        top.push(float(d[ai, bj]), i0 + int(ai), j0 + int(bj))
        out = top.sorted()[:k]
        pairs = np.asarray([[i, j] for _, i, j in out], dtype=np.int32).reshape(-1, 2)
        dists = np.asarray([d for d, _, _ in out], dtype=np.float32)
        return CpResult(pairs=pairs, distances=dists, pairs_verified=count,
                        nodes_examined=0)


def calibrate_gamma(
    tree: FlatPMTree, pr: float = 0.85, n_pairs: int = 200_000, seed: int = 0
) -> float:
    """§6.3: sample point pairs, compute γ = R_LCA / ||o1', o2'||, return
    the `pr` quantile of its empirical distribution (Fig. 7)."""
    rng = np.random.default_rng(seed)
    n = tree.n_points
    if n < 2:
        return 1.0
    i = rng.integers(0, n, size=n_pairs)
    j = rng.integers(0, n, size=n_pairs)
    keep = i != j
    i, j = i[keep], j[keep]
    dist = np.linalg.norm(tree.points[i] - tree.points[j], axis=-1)
    keep = dist > 0
    i, j, dist = i[keep], j[keep], dist[keep]

    # LCA radius via parent-chain ascent (vectorized level walk)
    depth = tree.depth
    # node -> level lookup
    level_of = np.zeros(tree.n_nodes, np.int32)
    for lvl in range(depth):
        level_of[tree.level_offsets[lvl] : tree.level_offsets[lvl + 1]] = lvl
    a = tree.point_leaf[i].astype(np.int64)
    b = tree.point_leaf[j].astype(np.int64)
    la, lb = level_of[a], level_of[b]
    # lift deeper one up
    for _ in range(depth):
        deeper = la > lb
        a[deeper] = tree.parent[a[deeper]]
        la[deeper] -= 1
        deeper = lb > la
        b[deeper] = tree.parent[b[deeper]]
        lb[deeper] -= 1
    for _ in range(depth + 1):
        ne = a != b
        if not ne.any():
            break
        a[ne] = tree.parent[a[ne]]
        b[ne] = tree.parent[b[ne]]
    R = tree.radii[a]
    gamma = R / dist
    gamma = gamma[np.isfinite(gamma)]
    if gamma.size == 0:
        return 1.0
    return float(np.quantile(gamma, pr))
