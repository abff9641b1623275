"""Result and protocol types shared by every index backend.

The contract (DESIGN.md §4): one estimator + one candidate budget
(T = βn + k), many probing mechanisms.  Whatever the mechanism — host
PM-tree rounds, a dense device pass, a sharded tournament, or a
competitor baseline — a query returns the same shapes and dtypes:

  indices   (B, k) int32    — dataset ids, -1 where a backend returned
                              fewer than k results
  distances (B, k) float32  — original-space distances, +inf on padding

so harnesses, serving steps, and tests never special-case a backend.
A copy of ``repro.index.types``: results are numpy arrays in both
packages, so the two facades compare like with like.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol, Sequence, runtime_checkable

import numpy as np

__all__ = ["WorkStats", "SearchResult", "CpSearchResult", "Index",
           "MutableIndex", "pack_batch"]


@dataclasses.dataclass
class WorkStats:
    """Unified work accounting (paper Table 2 cost model), summed over
    the batch.  Backends that cannot observe a counter report zero."""

    rounds: int = 0  # range-query / probing rounds issued
    candidates_verified: int = 0  # EXACT original-space distance comps
    # realized T: select-stage survivors (summed over the batch).  The
    # fused radius path reports points actually inside the final τ —
    # the calibration signal for query-adaptive termination (ROADMAP
    # §2); rank-cut paths select exactly the T budget and report that;
    # tree/host paths with no dense select stage report 0.
    candidates_selected: int = 0
    node_distance_computations: int = 0  # tree-node pruning distances
    # estimate-tier per-point distance comps: leaf-scan projected
    # distances (pmtree), code-estimated ADC distances (quant rerank);
    # candidates_verified stays the cross-backend-comparable exact count
    point_distance_computations: int = 0
    # closest-pair accounting (§6 radius filter): pair distance comps
    # issued by the join and whole tiles skipped by the γ·t·ub filter.
    # pairs_verified mirrors the CP share of candidates_verified /
    # point_distance_computations (exact vs code-estimated joins), so
    # it is NOT added into total_distance_computations again.
    pairs_verified: int = 0
    tiles_pruned: int = 0
    # facade-level hygiene: query rows masked to sentinel results
    # because they carried NaN/Inf (appended after the counters above —
    # as_dict/from_dict tolerate the skew, and older positional
    # constructions stay valid)
    queries_rejected: int = 0
    # sharded accounting (DESIGN.md §15): mesh width and per-shard work
    # skew.  The summed counters above stay globally comparable (a P-way
    # run sums its shards before reporting), while the max-shard fields
    # expose the straggler: max over shards of that shard's select
    # survivors (ANN) / verified pairs (CP).  Max-semantics under
    # aggregation — summing two batches must not add skews.
    shards: int = 0
    max_shard_candidates: int = 0
    max_shard_pairs: int = 0

    # fields that aggregate by max, not sum (skew/topology, not work)
    _MAX_FIELDS = frozenset({"shards", "max_shard_candidates",
                             "max_shard_pairs"})

    def __add__(self, other: "WorkStats") -> "WorkStats":
        return WorkStats(**{
            f.name: (max(getattr(self, f.name), getattr(other, f.name))
                     if f.name in self._MAX_FIELDS
                     else getattr(self, f.name) + getattr(other, f.name))
            for f in dataclasses.fields(self)
        })

    @property
    def total_distance_computations(self) -> int:
        return (self.candidates_verified
                + self.node_distance_computations
                + self.point_distance_computations)

    def as_dict(self) -> dict[str, int]:
        """Plain-int field dict — the exchange form trace span attrs
        and BENCH_*.json rows embed (numpy ints are coerced so the
        result is JSON-serializable as-is)."""
        return {f.name: int(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "WorkStats":
        """Inverse of :meth:`as_dict`; unknown keys are ignored and
        missing ones default to zero, so trajectory files written by
        older revisions still load."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in names})


@dataclasses.dataclass
class SearchResult:
    """Batched (c,k)-ANN answer: always (B, k), always int32/float32."""

    indices: np.ndarray
    distances: np.ndarray
    stats: WorkStats = dataclasses.field(default_factory=WorkStats)

    def __post_init__(self):
        self.indices = np.asarray(self.indices, dtype=np.int32)
        self.distances = np.asarray(self.distances, dtype=np.float32)
        if self.indices.shape != self.distances.shape:
            raise ValueError(
                f"indices {self.indices.shape} != distances "
                f"{self.distances.shape}"
            )

    @property
    def batch(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]


@dataclasses.dataclass
class CpSearchResult:
    """(c,k)-ACP answer: pairs (k, 2) int32, distances (k,) float32."""

    pairs: np.ndarray
    distances: np.ndarray
    stats: WorkStats = dataclasses.field(default_factory=WorkStats)

    def __post_init__(self):
        self.pairs = np.asarray(self.pairs, dtype=np.int32).reshape(-1, 2)
        self.distances = np.asarray(self.distances, dtype=np.float32)


@runtime_checkable
class Index(Protocol):
    """What every registered backend provides (see registry.py)."""

    n: int
    d: int

    def search(self, queries, k: int | None = None) -> SearchResult:
        """Batched (c,k)-ANN: queries (B, d) or (d,) → (B, k) results."""
        ...

    def cp_search(self, k: int) -> CpSearchResult:
        """(c,k)-ACP over the indexed data (CP-capable backends only)."""
        ...


@runtime_checkable
class MutableIndex(Index, Protocol):
    """What "stream"-capable backends additionally provide."""

    def insert(self, points) -> np.ndarray:
        """Append rows; returns their new global ids (n,).  Inserted
        points are visible to search immediately."""
        ...

    def delete(self, ids) -> int:
        """Tombstone ids (never returned again); returns the number
        that were live."""
        ...

    def flush(self) -> None:
        """Seal buffered inserts into immutable storage."""
        ...


def pack_batch(
    rows: Iterable[tuple[Sequence[int], Sequence[float]]], k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-query (ids, distances) rows into (B, k) int32/float32."""
    rows = list(rows)
    indices = np.full((len(rows), k), -1, dtype=np.int32)
    distances = np.full((len(rows), k), np.inf, dtype=np.float32)
    for b, (ids, dd) in enumerate(rows):
        ids = np.asarray(ids).reshape(-1)[:k]
        dd = np.asarray(dd).reshape(-1)[:k]
        indices[b, : ids.size] = ids.astype(np.int32)
        distances[b, : dd.size] = dd.astype(np.float32)
    return indices, distances
