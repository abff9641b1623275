"""The "flat" PM-LSH index on the card: a dense estimate → select →
verify pipeline, the counterpart of ``repro.core.flat_index``.

    1. estimate:  d'_i = ||x_i @ A - q'||²       (pairwise kernel)
    2. select:    the T = βn + k smallest d'_i    (the candidate set C)
    3. verify:    exact ||x_i - q||² on C         (pairwise kernel, rows)
    4. answer:    the k smallest exact distances

Same estimator and candidate budget as the paper (Lemmas 1-4); only the
probing mechanism differs from the PM-tree.  Every ``lax.top_k`` of the
reference that sits outside a kernel is a stable sort here
(``ref.topk_smallest``), which keeps its lowest-index tie-break.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from .estimator import PMLSHParams, solve_parameters
from .hashing import ProjectionFamily

__all__ = ["FlatIndex", "build_flat_index", "candidate_budget",
           "answer_distances", "ann_query", "ann_search"]


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Device-resident flat PM-LSH index.

    data:      (n, d) original points.
    projected: (n, m) = data @ family.a, computed once at build time.
    family:    the projection family (holds A).
    params:    Eq. 10 solution cached at build time, so queries never
               re-run the χ² quantile solver.
    """

    data: torch.Tensor
    projected: torch.Tensor
    family: ProjectionFamily
    params: PMLSHParams | None = None

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def d(self) -> int:
        return self.data.shape[1]

    @property
    def m(self) -> int:
        return self.projected.shape[1]


def build_flat_index(data, m: int = 15, seed: int = 0, c: float = 1.5, *,
                     device: str | torch.device = "cuda",
                     generator: torch.Generator | None = None) -> FlatIndex:
    """Index ``data`` (n, d) on ``device``; A is drawn from ``generator``
    (default: a CPU generator seeded with ``seed``)."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        data = data.to(device=dev, dtype=torch.float32).contiguous()
    else:
        data = as_tensor(data, dev)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    family = ProjectionFamily.create(data.shape[1], m, generator=generator,
                                     device=dev)
    return FlatIndex(data=data, projected=family.project(data), family=family,
                     params=solve_parameters(c, m=m))


def candidate_budget(params: PMLSHParams, n: int, k: int) -> int:
    """T = βn + k, clamped to [k, n]."""
    return int(min(max(int(np.ceil(params.beta * n)) + k, k), n))


def answer_distances(data: torch.Tensor, ids: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Canonical answer distances: ||q_b − data[ids[b, j]]||, +inf where
    id < 0, summed in the difference form as the reference does
    (flat_index.py:84-104): the pipeline's d² only ranked the candidates.
    """
    rows = data[torch.clamp_min(ids.to(torch.int64), 0)]  # (B, k, d)
    d2 = ((rows - q[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(ids < 0, float("inf"), d2)
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def ann_query(index: FlatIndex, q: torch.Tensor, *, k: int, T: int,
              fused: bool = False, force: str | None = None,
              with_count: bool = False):
    """(c,k)-ANN for a batch of queries.

    Args:
      q: (B, d) query batch on the index's device.
      k: results per query.
      T: candidate budget (βn + k) from :func:`candidate_budget`.
      fused: run ``core.fused.fused_ann_query`` (radius-threshold select
        and gather-free verify) instead of the sort-and-gather path;
        identical answers on ties-free data.
      force: kernel dispatch override (None or "plain").
      with_count: also return the select stage's per-query survivor
        counts (B,) int32; this path's rank cut selects exactly T.

    Returns (indices (B, k) int32, distances (B, k) float32), plus the
    counts when ``with_count``.
    """
    if fused:
        from .fused import fused_ann_query

        return fused_ann_query(index, q, k=k, T=T, force=force,
                               with_count=with_count)
    q = q.to(torch.float32)
    if q.ndim == 1:
        q = q[None]
    qp = index.family.project(q)  # (B, m)

    # 1-2. estimate + select: projected distances, T smallest
    d2p = kops.pairwise_sq_dist(qp, index.projected, force=force)  # (B, n)
    _, cand = kref.topk_smallest(d2p, T)  # (B, T)

    # 3. verify: exact distances on the gathered candidate rows
    rows = index.data[cand.to(torch.int64)]  # (B, T, d)
    d2 = kops.pairwise_sq_dist(q, rows, force=force)  # (B, T)

    # 4. answer
    vals, sel = kref.topk_smallest(d2, k)
    idx = torch.gather(cand, 1, sel.to(torch.int64))
    out = idx, torch.sqrt(torch.clamp_min(vals, 0.0))
    if with_count:
        return out + (torch.full((q.shape[0],), T, dtype=torch.int32,
                                 device=q.device),)
    return out


def ann_search(index: FlatIndex, q, k: int, c: float = 1.5,
               params: PMLSHParams | None = None, use_kernels: bool = True,
               fused: bool = False):
    """Convenience wrapper: pick T from the build-time parameter cache
    (re-solving Eq. 10 only when queried at a different ratio c), then
    :func:`ann_query` on the index's device.  ``q`` (B, d) or (d,) is
    numpy or a tensor; ``use_kernels=False`` runs the kernels' plain
    versions."""
    if params is None:
        if index.params is not None and index.params.c == c:
            params = index.params
        else:
            params = solve_parameters(c, m=index.m)
    T = candidate_budget(params, index.n, k)
    dev = index.data.device
    q = q.to(dev) if isinstance(q, torch.Tensor) else as_tensor(q, dev)
    return ann_query(index, q, k=k, T=T, fused=fused,
                     force=None if use_kernels else "plain")
