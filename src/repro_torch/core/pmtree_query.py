"""PM-tree range queries: the host DFS (paper-faithful, counted) and the
level-synchronous masked traversal on the card.

The host path mirrors the paper's Algorithm (depth-first + Eq. 5
pruning) and counts distance computations so the Table-2 cost-model
comparison can be validated against actual traversals; it is a copy of
``repro.core.pmtree_query``'s.

The device path evaluates Eq. 5 densely per level: every node is tested
at once with tensor boolean algebra, children inherit their parent's
verdict level by level, and the surviving leaves induce a point mask.
There is no data-dependent control flow.  Its one ``lax.top_k`` of the
reference is a stable sort here, which keeps the lowest-index
tie-break.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pmtree import FlatPMTree

__all__ = ["range_query_host", "DeviceTree", "range_mask_device",
           "range_query_device", "QueryStats"]


@dataclasses.dataclass
class QueryStats:
    """Work counters for the host traversal (cost-model validation)."""

    nodes_accessed: int = 0
    node_distance_computations: int = 0  # ||q, e.RO|| evaluations
    point_distance_computations: int = 0  # ||q, o'|| evaluations (leaf scans)

    @property
    def total_distance_computations(self) -> int:
        return self.node_distance_computations + self.point_distance_computations


def range_query_host(
    tree: FlatPMTree, q: np.ndarray, radius: float
) -> tuple[np.ndarray, QueryStats]:
    """Depth-first range(q, r) with Eq. 5 pruning.

    Returns (slot indices into tree.points within the ball, stats).
    Pivot distances ||q,p_i|| are computed once (s distance comps).
    """
    q = np.asarray(q, dtype=np.float32)
    stats = QueryStats()
    qp = np.linalg.norm(tree.pivots - q, axis=-1)  # (s,)
    stats.node_distance_computations += tree.n_pivots
    out: list[np.ndarray] = []
    stack = [0]
    while stack:
        e = stack.pop()
        stats.nodes_accessed += 1
        # hyper-ring tests first: they reuse the cached qp distances (free)
        if ((qp - radius) > tree.hr_max[e]).any() or (
            (qp + radius) < tree.hr_min[e]
        ).any():
            continue
        d = float(np.linalg.norm(tree.centers[e] - q))
        stats.node_distance_computations += 1
        if d > tree.radii[e] + radius:
            continue
        if tree.child_count[e] == 0:  # leaf — scan members
            s, c = int(tree.leaf_start[e]), int(tree.leaf_count[e])
            pts = tree.points[s : s + c]
            dist = np.linalg.norm(pts - q, axis=-1)
            stats.point_distance_computations += c
            hit = np.where(dist <= radius)[0] + s
            if hit.size:
                out.append(hit)
        else:
            cs, cc = int(tree.child_start[e]), int(tree.child_count[e])
            stack.extend(range(cs, cs + cc))
    slots = np.concatenate(out) if out else np.zeros(0, np.int64)
    return slots, stats


# --------------------------------------------------------------------------
# device path
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceTree:
    """The FlatPMTree arrays the range mask reads, as tensors on one
    device (node and point ids as int64)."""

    centers: torch.Tensor
    radii: torch.Tensor
    hr_min: torch.Tensor
    hr_max: torch.Tensor
    parent: torch.Tensor
    point_leaf: torch.Tensor
    points: torch.Tensor
    pivots: torch.Tensor
    level_offsets: tuple[int, ...]

    @staticmethod
    def from_host(tree: FlatPMTree, device: str | torch.device) -> "DeviceTree":
        def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        f32, i64 = torch.float32, torch.int64
        return DeviceTree(
            centers=put(tree.centers, f32),
            radii=put(tree.radii, f32),
            hr_min=put(tree.hr_min, f32),
            hr_max=put(tree.hr_max, f32),
            parent=put(tree.parent, i64),
            point_leaf=put(tree.point_leaf, i64),
            points=put(tree.points, f32),
            pivots=put(tree.pivots, f32),
            level_offsets=tuple(int(x) for x in tree.level_offsets),
        )


def range_mask_device(tree: DeviceTree, q, radius) -> torch.Tensor:
    """Level-synchronous masked range query.

    Returns a boolean mask over point *slots* (tree.points order) that is
    True exactly for points whose node chain passes Eq. 5 AND whose own
    projected distance is within ``radius``.  Dense per level: one test of
    every node, then one masked parent lookup a level.  The radius is
    taken as float32, as the reference's traced radius is.
    """
    dev = tree.points.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    qp = torch.linalg.vector_norm(tree.pivots - q[None, :], dim=-1)  # (s,)

    # per-node Eq. 5 test, all nodes at once (N_nodes ≈ n/M · 16/15)
    dc = torch.linalg.vector_norm(tree.centers - q[None, :], dim=-1)  # (N,)
    ball_ok = dc <= tree.radii + r
    ring_ok = (((qp[None, :] - r) <= tree.hr_max)
               & ((qp[None, :] + r) >= tree.hr_min)).all(dim=-1)
    passed = ball_ok & ring_ok  # (N,)

    # propagate down the levels: a node passes iff it and its parent pass
    offs = tree.level_offsets
    for lvl in range(1, len(offs) - 1):
        lo, hi = offs[lvl], offs[lvl + 1]
        passed[lo:hi] &= passed[tree.parent[lo:hi]]

    leaf_pass = passed[tree.point_leaf]  # (n,)
    dist = torch.linalg.vector_norm(tree.points - q[None, :], dim=-1)
    return leaf_pass & (dist <= r)


def range_query_device(tree: DeviceTree, q, radius, max_results: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size range query: returns (slots, proj_dists, valid_mask) of
    the up-to-``max_results`` nearest in-ball points (projected space),
    ties to the lowest slot."""
    q = torch.as_tensor(q, dtype=torch.float32, device=tree.points.device)
    mask = range_mask_device(tree, q, radius)
    dist = torch.linalg.vector_norm(tree.points - q[None, :], dim=-1)
    masked = torch.where(mask, dist, torch.full_like(dist, float("inf")))
    d, idx = torch.sort(masked, stable=True)
    d, idx = d[:max_results], idx[:max_results]
    return idx, d, torch.isfinite(d)
