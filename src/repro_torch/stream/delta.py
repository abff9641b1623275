"""The mutable delta buffer: the LSM memtable of the streaming index
(``repro.stream.delta``).

Freshly inserted points live here until ``StreamingIndex.flush`` seals
them into an immutable segment.  Their ids stay a host int64 array; the
vectors live on the index's device in a buffer that grows by doubling,
so a search never uploads the delta again.  A flush hands the buffer to
the new segment and the delta starts another: rows go up to the device
once, and a bulk insert is never held there twice.  Queries against the delta
are an exact scan through ``repro_torch.kernels.ops``: pairwise squared
distances, then the row-wise top-k.

Deletes of ids still in the delta need no tombstone: the row is
physically dropped on the spot.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor
from ..index.types import WorkStats
from ..kernels import ops

__all__ = ["DeltaBuffer"]


class DeltaBuffer:
    """Append-mostly (id, vector) buffer with exact top-k scan."""

    def __init__(self, d: int, device: torch.device):
        self.d = int(d)
        self.device = device
        self.ids = np.empty((0,), dtype=np.int64)
        self._rows = torch.empty((0, self.d), dtype=torch.float32, device=device)

    def __len__(self) -> int:
        return self.ids.size

    @property
    def vectors(self) -> torch.Tensor:
        """The buffered rows (len, d), a view of the device buffer.
        ``take`` lets go of the buffer, so a segment built from this
        view before the drain holds the rows without a copy."""
        return self._rows[: len(self)]

    def insert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, dtype=np.float32).reshape(-1, self.d)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size != vectors.shape[0]:
            raise ValueError(f"{ids.size} ids for {vectors.shape[0]} rows")
        n, cnt = len(self), ids.size
        if n + cnt > self._rows.shape[0]:
            grown = torch.empty((max(n + cnt, 2 * self._rows.shape[0], 1024), self.d),
                                dtype=torch.float32, device=self.device)
            grown[:n] = self._rows[:n]
            self._rows = grown
        self._rows[n:n + cnt] = as_tensor(vectors, self.device)
        self.ids = np.concatenate([self.ids, ids])

    def delete(self, ids) -> np.ndarray:
        """Physically drop rows whose id is in ``ids``; returns the
        (possibly empty) array of ids actually removed."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        hit = np.isin(self.ids, ids)
        removed = self.ids[hit]
        if removed.size:
            keep = torch.from_numpy(np.flatnonzero(~hit)).to(self.device)
            self._rows[: keep.numel()] = self._rows[keep]
            self.ids = self.ids[~hit]
        return removed

    def take(self) -> np.ndarray:
        """Drain the buffer: returns the ids and resets to empty.  The
        device buffer is let go of (whoever holds ``vectors`` keeps it);
        the next insert allocates a new one."""
        ids = self.ids
        self.ids = np.empty((0,), dtype=np.int64)
        self._rows = self._rows[:0].clone()
        return ids

    def search(self, q: np.ndarray, k: int, *, force: str | None = None
               ) -> tuple[np.ndarray, np.ndarray, WorkStats]:
        """Exact top-k over the buffer: (global ids (B,k'), distances
        (B,k'), WorkStats) with k' = min(k, len(self))."""
        B, n = q.shape[0], len(self)
        kk = min(int(k), n)
        if kk == 0:
            return (np.empty((B, 0), np.int64), np.empty((B, 0), np.float32),
                    WorkStats())
        d2 = ops.pairwise_sq_dist(as_tensor(q, self.device), self.vectors, force=force)
        vals, idx = ops.topk_smallest(d2, kk, force=force)
        gids = self.ids[idx.cpu().numpy().astype(np.int64)]
        dd = np.sqrt(np.maximum(vals.cpu().numpy(), np.float32(0.0)))
        return gids, dd, WorkStats(candidates_verified=B * n,
                                   point_distance_computations=B * n)
