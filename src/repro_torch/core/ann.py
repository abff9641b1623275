"""Paper-faithful NN query processing on the PM-tree (paper §5).

Implements Algorithm 1 ((r,c)-BC query) and Algorithm 2 ((c,k)-ANN
query) exactly as written: a sequence of PM-tree range queries in the
projected space with radius ``t·r`` and ``r ← c·r`` enlargement, with
the two termination conditions, candidate verification in the original
space, and full work counters for the cost-model experiments.

The counterpart of ``repro.core.ann``.  Only the projections run on the
index's device (the data's once, at build, and each query's); the tree,
the range queries and the verification are the reference's host
algorithm, so every work counter is the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from .estimator import PMLSHParams, select_rmin, solve_parameters
from .hashing import host_projection, project_to_host
from .pmtree import FlatPMTree, build_bulk, build_insert
from .pmtree_query import QueryStats, range_query_host

__all__ = ["PMLSH", "AnnResult", "host_rows"]


def host_rows(data) -> np.ndarray:
    """``data`` (n, d) as host float32 numpy (a tensor is copied off its
    device)."""
    if isinstance(data, torch.Tensor):
        return data.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(data, dtype=np.float32)


@dataclasses.dataclass
class AnnResult:
    indices: np.ndarray  # (k,) int32 original dataset ids
    distances: np.ndarray  # (k,) float32 original-space distances
    rounds: int  # number of range queries issued
    candidates_verified: int  # |C| — original-space distance computations
    stats: QueryStats  # accumulated tree-traversal work


class PMLSH:
    """The PM-LSH index of the paper: projection family + PM-tree.

    Parameters follow §7.1 defaults: m = 15 hash functions, s = 5
    pivots, node capacity M = 16, α₁ = 1/e, β from Eq. 10.  A is drawn
    from ``seed`` on ``device`` unless ``a`` (d, m) is given;
    ``projected`` (n, m) is taken as given when passed, so an index
    carried across from JAX builds the JAX index's tree.
    """

    def __init__(
        self,
        data,
        *,
        m: int = 15,
        s: int = 5,
        capacity: int = 16,
        fanout: int = 4,
        c: float = 1.5,
        alpha1: float = 1.0 / math.e,
        beta: float | None = None,
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
        self.params: PMLSHParams = solve_parameters(c, m=m, alpha1=alpha1, beta=beta)
        if builder == "bulk":
            self.tree: FlatPMTree = build_bulk(
                self.projected, capacity=capacity, fanout=fanout, n_pivots=s,
                seed=seed,
            )
        else:
            self.tree = build_insert(
                self.projected, capacity=capacity, n_pivots=s, seed=seed,
                promote=promote,
            )
        # §5.2: r_min from the empirical original-space distance distribution
        self._rmin_cache: dict[int, float] = {}

    # -- parameters ------------------------------------------------------

    @property
    def t(self) -> float:
        return self.params.t

    @property
    def beta(self) -> float:
        return self.params.beta

    def rmin(self, k: int) -> float:
        if k not in self._rmin_cache:
            self._rmin_cache[k] = select_rmin(
                self.data, self.beta, k, n_samples=min(50_000, self.n * 20)
            )
        return self._rmin_cache[k]

    def project_query(self, q: np.ndarray) -> np.ndarray:
        """q (d,) projected on the index's device, as host float32 (m,)."""
        return project_to_host(self.family, np.asarray(q, dtype=np.float32)[None])[0]

    # -- Algorithm 1: (r,c)-BC -------------------------------------------

    def bc_query(self, q: np.ndarray, r: float):
        """(r,c)-ball-cover query.  Returns (point id | None, stats)."""
        q = np.asarray(q, dtype=np.float32)
        qp = self.project_query(q)
        slots, stats = range_query_host(self.tree, qp, self.t * r)
        beta_n = self.beta * self.n
        if slots.size == 0:
            return None, stats
        ids = self.tree.perm[slots]
        dist = np.linalg.norm(self.data[ids] - q, axis=-1)
        best = int(np.argmin(dist))
        if slots.size >= beta_n + 1:
            return (int(ids[best]), stats)
        if dist[best] <= self.params.c * r:
            return (int(ids[best]), stats)
        return None, stats

    # -- Algorithm 2: (c,k)-ANN ------------------------------------------

    def ann_query(self, q: np.ndarray, k: int = 1, rmin: float | None = None) -> AnnResult:
        q = np.asarray(q, dtype=np.float32)
        qp = self.project_query(q)
        c, t = self.params.c, self.t
        beta_n = self.beta * self.n
        r = float(rmin if rmin is not None else self.rmin(k))
        total = QueryStats()
        rounds = 0
        verified: dict[int, float] = {}  # slot -> original distance

        def verify(slots: np.ndarray):
            new = [s for s in slots.tolist() if s not in verified]
            if new:
                ids = self.tree.perm[np.asarray(new)]
                d = np.linalg.norm(self.data[ids] - q, axis=-1)
                for s_, d_ in zip(new, d.tolist()):
                    verified[s_] = d_

        while True:
            # termination 1 (line 4): k candidates already within c·r
            if len(verified) >= k:
                dists = np.fromiter(verified.values(), dtype=np.float64)
                if int((dists <= c * r).sum()) >= k:
                    break
            rounds += 1
            slots, stats = range_query_host(self.tree, qp, t * r)
            total.nodes_accessed += stats.nodes_accessed
            total.node_distance_computations += stats.node_distance_computations
            total.point_distance_computations += stats.point_distance_computations
            verify(slots)
            # termination 2 (line 9): enough candidates collected
            if slots.size >= beta_n + k:
                break
            r *= c

        slots_arr = np.fromiter(verified.keys(), dtype=np.int64)
        dist_arr = np.fromiter(verified.values(), dtype=np.float64)
        order = np.argsort(dist_arr)[:k]
        ids = self.tree.perm[slots_arr[order]]
        return AnnResult(
            indices=ids.astype(np.int32),
            distances=dist_arr[order].astype(np.float32),
            rounds=rounds,
            candidates_verified=len(verified),
            stats=total,
        )

    # -- exact reference ---------------------------------------------------

    def exact_knn(self, q: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        d = np.linalg.norm(self.data - np.asarray(q, np.float32), axis=-1)
        idx = np.argsort(d)[:k]
        return idx, d[idx]
