"""The legacy sharded PM-LSH (the ``sharded`` backend), the counterpart of
``repro.core.distributed``, over a :class:`~repro_torch.launch.DataMesh`.

ANN (:class:`DistributedFlatIndex`): the points are split by rows, the
last shard padded with +inf rows.  A query is replicated; every shard
keeps the local top-T′ of its projected distances (T′ = ⌈T/P⌉ + k,
at most its row count), verifies them exactly, and one all-gather of
the P·T′ (distance, global id) pairs with a final top-k completes the
merge.  Its local rank cut splits the budget heuristically, so its
answers are not the flat index's (``sharded-flat`` is the exact one).

CP (:class:`DistributedCP`): each shard self-joins, the least k-th best
over the shards is ub, then the blocks pass P − 1 times around a ring
and only cross pairs whose projected distance passes t·ub are verified.

Plain PyTorch on any device, as the reference is jnp: no kernel.  Every
``lax.top_k`` of the reference ranks by the total order of float bits
(−NaN < −inf < … < +inf < +NaN) with ties to the lowest index, and so
does every selection here, which keeps the reference's choice among the
NaN estimates of the +inf padding rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..launch.mesh import DataMesh, make_data_mesh
from ..launch.sharding import shard_rows
from .estimator import solve_parameters
from .hashing import ProjectionFamily
from .sharded import local_blocks, pad_tensor

__all__ = ["DistributedFlatIndex", "DistributedCP", "top_k_total_order"]

_INF = float("inf")


def top_k_total_order(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) int64 of the k largest of x (B, N) float32 in the
    total order of float bits, ties to the lowest index: the ranking
    ``lax.top_k`` makes (NaN above +inf by its sign bit)."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


class _Layout:
    """The mesh, the projection and the +inf-padded row blocks of both
    legacy engines (the reference's ``shard_points``)."""

    def __init__(self, data, mesh: DataMesh | None, m: int, seed: int, axis: str,
                 a, projected, device):
        self.mesh = mesh if mesh is not None else make_data_mesh(axis=axis, device=device)
        dev = self.mesh.device
        self.data_host = np.asarray(data, np.float32)
        self.n, d = self.data_host.shape
        self.family = (ProjectionFamily.from_seed(d, m, seed, dev) if a is None
                       else ProjectionFamily.from_numpy(a, dev))
        data_t = as_tensor(self.data_host, dev)
        proj = self.family.project(data_t) if projected is None else as_tensor(projected, dev)
        P = self.mesh.size
        self.nl = nl = shard_rows(self.n, P)
        self.blocks = list(zip(local_blocks(self.mesh, pad_tensor(data_t, P * nl, _INF)),
                               local_blocks(self.mesh, pad_tensor(proj, P * nl, _INF))))


def _norm_trick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's unclamped ``Σa² + Σb² − 2.0 * a @ bᵀ``."""
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
            - (2.0 * a) @ b.T)


class DistributedFlatIndex:
    """Legacy sharded flat PM-LSH index over a data mesh.

    ``mesh`` defaults to ``make_data_mesh(device=device)``; ``a`` and
    ``projected`` take a given projection (e.g. the JAX index's
    ``family.a`` and its unpadded projected rows)."""

    def __init__(self, data, mesh: DataMesh | None = None, m: int = 15, seed: int = 0,
                 axis: str = "data", *, a: np.ndarray | None = None,
                 projected: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        self._lay = _Layout(data, mesh, m, seed, axis, a, projected, device)
        self.mesh, self.family, self.n = self._lay.mesh, self._lay.family, self._lay.n

    @classmethod
    def from_arrays(cls, data, a: np.ndarray, projected: np.ndarray | None = None,
                    mesh: DataMesh | None = None, **kwargs) -> "DistributedFlatIndex":
        return cls(data, mesh, a=a, projected=projected, **kwargs)

    def local_budget(self, T: int, k: int) -> int:
        """Per-shard candidate budget: ⌈T/P⌉ + k slack, ≤ shard size."""
        return min(-(-T // self.mesh.size) + k, self._lay.nl)

    def query(self, q, k: int, T: int | None = None):
        """(ids (B, k) int32, distances (B, k) float32) as numpy."""
        mesh, nl = self.mesh, self._lay.nl
        q = torch.from_numpy(np.atleast_2d(np.asarray(q, np.float32))).to(mesh.device)
        qp = self.family.project(q)
        T = T or max(4 * k, 64)
        local_T = self.local_budget(T, k)
        d2s, gids = [], []
        for p, (data_blk, proj_blk) in zip(mesh.local, self._lay.blocks):
            idx = top_k_total_order(-_norm_trick(qp, proj_blk), local_T)  # local SELECT
            d2s.append(((data_blk[idx] - q[:, None, :]) ** 2).sum(-1))  # local VERIFY
            gids.append(idx + p * nl)
        d2 = torch.cat(mesh.all_gather(d2s), 1)
        gid = torch.cat(mesh.all_gather(gids), 1)
        d2 = torch.where(gid < self.n, d2, _INF)
        sel = top_k_total_order(-d2, k)
        ids = torch.gather(gid, 1, sel).to(torch.int32)
        dists = torch.sqrt(torch.gather(d2, 1, sel))
        return ids.cpu().numpy(), dists.cpu().numpy()


def _pair_min(a_pts, a_gid, b_pts, b_gid, k: int, n_valid: int, same: bool, gate=None):
    """k best pairs of two blocks by the unclamped norm trick: (d², gid_a,
    gid_b, pairs counted)."""
    d2 = _norm_trick(a_pts, b_pts)
    valid = (a_gid[:, None] < n_valid) & (b_gid[None, :] < n_valid)
    if same:
        valid &= a_gid[:, None] < b_gid[None, :]
    if gate is not None:
        valid &= gate
    d2 = torch.where(valid, d2, _INF).reshape(1, -1)
    kb = min(k, d2.shape[1])
    idx = top_k_total_order(-d2, kb)[0]
    nb = b_pts.shape[0]
    d, i, j = d2[0, idx], a_gid[idx // nb], b_gid[idx % nb]
    if kb < k:  # a block pair smaller than k: +inf slots merge away
        d = torch.cat([d, d.new_full((k - kb,), _INF)])
        i = torch.cat([i, i.new_zeros(k - kb)])
        j = torch.cat([j, j.new_zeros(k - kb)])
    return d, i, j, valid.sum()


def _keep_best(d, i, j, k: int):
    sel = top_k_total_order(-d[None], k)[0]
    return d[sel], i[sel], j[sel]


class DistributedCP:
    """Ring-based closest-pair search with radius filtering, over a data
    mesh (``mesh``, ``a`` and ``projected`` as :class:`DistributedFlatIndex`)."""

    def __init__(self, data, mesh: DataMesh | None = None, m: int = 15, c: float = 4.0,
                 seed: int = 0, axis: str = "data", *, a: np.ndarray | None = None,
                 projected: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        self._lay = _Layout(data, mesh, m, seed, axis, a, projected, device)
        self.mesh, self.n = self._lay.mesh, self._lay.n
        self.data_host = self._lay.data_host  # the exact re-verification's rows
        self.t = solve_parameters(c, m=m).t

    @classmethod
    def from_arrays(cls, data, a: np.ndarray, projected: np.ndarray | None = None,
                    mesh: DataMesh | None = None, **kwargs) -> "DistributedCP":
        return cls(data, mesh, a=a, projected=projected, **kwargs)

    def cp_query(self, k: int, with_stats: bool = False):
        """Returns (pairs, distances)[, pairs_verified if with_stats]."""
        mesh, nl, n = self.mesh, self._lay.nl, self.n
        dev = mesh.device
        mine, best, cnt = [], [], []
        for p, (data_blk, proj_blk) in zip(mesh.local, self._lay.blocks):
            gid = torch.arange(p * nl, (p + 1) * nl, dtype=torch.int32, device=dev)
            mine.append((data_blk, proj_blk, gid))
            d, i, j, c = _pair_min(data_blk, gid, data_blk, gid, k, n, True)
            best.append((d, i, j))
            cnt.append(c)
        # the global ub: the least of the shards' k-th best self-join d²
        kth = [torch.sort(b[0]).values[k - 1].reshape(1) for b in best]
        ub = torch.cat(mesh.all_gather(kth)).min()
        gate2 = self.t * self.t * ub  # the radius filter, squared
        recv = list(mine)
        for _ in range(mesh.size - 1):
            recv = mesh.ring(recv)
            for x, ((data_blk, proj_blk, gid), (r_pts, r_proj, r_gid)) in enumerate(
                    zip(mine, recv)):
                gate = _norm_trick(proj_blk, r_proj) <= gate2
                d, i, j, c = _pair_min(data_blk, gid, r_pts, r_gid, k, n, True, gate)
                b = best[x]
                best[x] = _keep_best(torch.cat([b[0], d]), torch.cat([b[1], i]),
                                     torch.cat([b[2], j]), k)
                cnt[x] = cnt[x] + c
        d, i, j = (torch.cat(mesh.all_gather([b[x] for b in best])) for x in range(3))
        d, i, j = _keep_best(d, i, j, k)
        verified = int(mesh.psum([c.reshape(1) for c in cnt]).item())
        pairs = torch.stack([i, j], 1).cpu().numpy().astype(np.int32)
        d = d.cpu().numpy()
        # drop the filler slots (inf distance: fewer real pairs than k)
        # before re-verifying, then recompute the winners in the
        # difference form and re-sort, as the reference does on the host
        real = np.isfinite(d) & (pairs[:, 0] != pairs[:, 1])
        pairs = pairs[real]
        diff = self.data_host[pairs[:, 0]] - self.data_host[pairs[:, 1]]
        d = np.sqrt(np.sum(diff * diff, axis=1)).astype(np.float32)
        resort = np.argsort(d, kind="stable")
        pairs, d = pairs[resort], d[resort]
        if with_stats:
            return pairs, d, verified
        return pairs, d
