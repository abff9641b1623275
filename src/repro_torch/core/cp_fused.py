"""The closest-pair engine on the card, the counterpart of
``repro.core.cp_fused`` (paper §6 on the fused stack):

    1. project   one 2-stable coordinate per point (the first column of
                 the m-dim family): a 1-D key whose pair gap lower-bounds
                 the m-dim projected distance;
    2. sort      points by key (a stable sort on the device);
    3. join      ``kernels/pair_join``: band-major sweep of the (n, n)
                 tile space, tiles whose key gap exceeds γ·t·ub skipped;
    4. emit      map row positions back through the sort permutation,
                 re-verify the k winners in the difference form, report
                 pairs_verified / tiles_pruned.

Traced, the stages open the reference's spans: ``cp.query`` over
``cp.project``, ``cp.sort``, ``cp.join`` (the ``kernel.pair_join`` span
inside) and ``cp.reverify``, each synchronized before it closes (only
while tracing: untraced, the path makes one host read, the answer's).

Every reported distance is an exact float32 distance; a true top-k pair
is missed only when its 1-D key gap exceeds γ·t·ub, with per-pair
probability ≤ 2Φ(−γt).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..kernels import ops as kops
from ..obs import trace as otrace
from .estimator import solve_parameters
from .hashing import ProjectionFamily

__all__ = ["CpFusedResult", "cp_fused_search", "cp_threshold2"]


@dataclasses.dataclass
class CpFusedResult:
    """(c,k)-ACP answer with the §6 radius-filter work counters."""

    pairs: np.ndarray  # (k', 2) int32 ids, i < j, ascending distance
    distances: np.ndarray  # (k',) float32 original distances
    pairs_verified: int  # pair distance computations issued by the join
    tiles_pruned: int  # tiles skipped by the γ·t·ub filter


@functools.lru_cache(maxsize=64)
def cp_threshold2(c: float, m: int, gamma: float,
                  alpha1: float = 1.0 / math.e) -> float:
    """(γ·t)², the squared radius-filter multiplier of Algorithm 4; t
    from the Eq. 10 solve at (c, m, α₁), solved once per argument set
    (the solve is host work the card would wait on every call)."""
    t = solve_parameters(c, m=m, alpha1=alpha1).t
    return float(gamma * t) ** 2


def cp_fused_search(
    data,
    k: int,
    *,
    m: int = 15,
    c: float = 4.0,
    gamma: float = 1.0,
    seed: int = 0,
    force: str | None = None,
    key: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> CpFusedResult:
    """(c,k)-ACP over ``data`` through the pair join.

    Args:
      data: (n, d) float32 points, a tensor (its device is used) or an
        array (placed on ``device``).
      k: pairs to return (clamped to n·(n−1)/2; short answers are not
        padded).
      m / c / seed: projection family size, CP approximation ratio and
        seed of the default key's projection.
      gamma: radius-filter slack (§6.3); larger = less pruning.
      force: kernel dispatch override (None or "plain").
      key: optional (n,) sort key (a 2-stable projection of the rows);
        the flat index passes its projection's first column.

    Returns ``CpFusedResult``: pair ids are rows of ``data``, each pair
    (i, j) with i < j, rows ascending by distance.
    """
    if isinstance(data, torch.Tensor):
        data = data.to(torch.float32)
    else:
        data = as_tensor(data, resolve_device(device))
    dev = data.device
    n, d = data.shape
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    kk = min(k, n * (n - 1) // 2)
    if kk == 0:
        return CpFusedResult(np.empty((0, 2), np.int32),
                             np.empty((0,), np.float32), 0, 0)
    with otrace.span("cp.query", n=n, d=d, k=kk):
        with otrace.span("cp.project"):
            if key is None:
                gen = torch.Generator().manual_seed(seed)
                family = ProjectionFamily.create(d, m, generator=gen, device=dev)
                key = data @ family.a[:, 0]
            key = otrace.block(key.to(device=dev, dtype=torch.float32).reshape(-1))
        if key.shape[0] != n:
            raise ValueError(f"key has {key.shape[0]} entries for n={n}")

        with otrace.span("cp.sort"):
            order = torch.sort(key, stable=True).indices
            xs, ks = otrace.block(data[order].contiguous(), key[order].contiguous())
        with otrace.span("cp.join"):
            thresh2 = cp_threshold2(c, m, gamma)
            _, pi, pj, stats = kops.pair_join(xs, ks, kk, thresh2=thresh2, force=force)

        with otrace.span("cp.reverify"):
            # no host read until the answer: the join's padding slots (−1)
            # map to row 0 and sort last as NaN, then one copy brings
            # everything back
            real = pi >= 0
            ids_a = order[pi.clamp_min(0).to(torch.int64)]
            ids_b = order[pj.clamp_min(0).to(torch.int64)]
            pairs = torch.stack([torch.minimum(ids_a, ids_b),
                                 torch.maximum(ids_a, ids_b)], 1)
            # the join ranks pairs by norm-trick distances, which cancel
            # exactly where closest pairs live (near-duplicates): recompute
            # the k winners in the difference form and re-sort
            diff = data[pairs[:, 0]] - data[pairs[:, 1]]
            dists = torch.where(real, torch.sqrt((diff * diff).sum(1)), float("nan"))
            resort = torch.sort(dists, stable=True).indices
            host = torch.cat([pairs[resort].to(torch.int64).reshape(-1),
                              dists[resort].view(torch.int32).to(torch.int64),
                              stats, real.sum().reshape(1)]).cpu().numpy()
    m = int(host[-1])
    pairs_h = host[:2 * kk].reshape(kk, 2)[:m].astype(np.int32)
    dists_h = host[2 * kk:3 * kk].astype(np.int32).view(np.float32)[:m]
    return CpFusedResult(pairs=pairs_h, distances=dists_h,
                         pairs_verified=int(host[3 * kk]),
                         tiles_pruned=int(host[3 * kk + 1]))
