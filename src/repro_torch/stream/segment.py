"""Sealed immutable segments: the LSM runs of the streaming index
(``repro.stream.segment``).

A segment is a frozen set of (global id, vector) rows served by a
registered static backend of the port that takes the index's projection:
``pmtree`` (the default, so sealed data gets the paper-faithful probing
path and its work counters), ``flat`` or ``flat-pq``.  The backend sees
local row numbers 0..n-1; the segment owns the local→global id remap.
Deletes never touch a segment: the owner tracks a tombstone count
(``dead``) per segment and compaction rebuilds when it grows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..index.config import IndexConfig
from ..index.types import SearchResult, WorkStats

__all__ = ["Segment", "segment_config"]

# stream-orchestration knobs that must not leak into the static
# backend's option namespace when a segment is built
_STREAM_OPTIONS = ("segment_backend", "delta_threshold", "max_segments",
                   "max_dead_fraction", "drift", "drift_baseline",
                   "durability")


def segment_config(config: IndexConfig, backend: str) -> IndexConfig:
    opts = {k: v for k, v in config.options.items()
            if k not in _STREAM_OPTIONS}
    return config.replace(backend=backend, options=opts)


class Segment:
    """One immutable run: global ids + a backend over rows already on
    the index's device, built with the projection ``a`` (d, m) given, so
    every segment of one index shares it, as every segment of the
    reference shares ``ProjectionFamily.create(d, m, seed)``.  A flat
    segment holds ``rows`` without a copy (the caller hands over a tensor
    nothing else writes to); a pmtree segment projects them on the
    device and takes them to the host for its tree.
    """

    _serial = 0  # process-wide serial — owner keys segments by it

    def __init__(self, ids: np.ndarray, rows: torch.Tensor, config: IndexConfig,
                 backend: str, *, a: np.ndarray):
        from ..index.backends import FlatBackend, PMTreeBackend
        from ..index.registry import get_backend

        self.ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if self.ids.size != rows.shape[0]:
            raise ValueError(f"{self.ids.size} ids for {rows.shape[0]} rows")
        self.backend = backend
        cls = get_backend(backend)
        if not issubclass(cls, (PMTreeBackend, FlatBackend)):
            raise ValueError(f"segment_backend {backend!r} is not flat-family or pmtree: "
                             "the port's segments take the index's projection")
        self.index = cls.from_arrays(rows, a, None, segment_config(config, backend),
                                     device=rows.device)
        self.dead = 0  # tombstones attributed to this segment
        Segment._serial += 1
        self.serial = Segment._serial

    @property
    def size(self) -> int:
        return self.ids.size

    def bytes_per_point(self) -> float:
        """Distance-storage bytes/point of the backing index (codes +
        codebooks for quantized segments, raw float32 otherwise)."""
        return float(self.index.bytes_per_point())

    @property
    def live(self) -> int:
        return self.ids.size - self.dead

    @property
    def dead_fraction(self) -> float:
        return self.dead / max(self.ids.size, 1)

    def search(self, q: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray, WorkStats]:
        """Top-k within the segment in GLOBAL id space.

        Asks the backend for min(size, k) rows; the owner widens k by
        ``dead`` so tombstone filtering at merge time cannot starve the
        answer.
        """
        res: SearchResult = self.index.search(q, min(int(k), self.size))
        local = np.asarray(res.indices, dtype=np.int64)
        gids = np.where(local >= 0, self.ids[np.maximum(local, 0)], -1)
        return gids, res.distances, res.stats

    def __repr__(self) -> str:
        return (f"Segment(serial={self.serial}, backend={self.backend!r}, "
                f"size={self.size}, dead={self.dead})")
