"""Row layout of the sharded index's arrays, the counterpart of
``repro.launch.sharding.index_row_pspec`` / ``index_shardings``.

Every index array (points, projections, codes, the closest-pair blocks)
is split by rows over the mesh's P shards, trailing dimensions whole.
The rows are first padded so that each shard holds the same count, a
multiple of ``multiple`` (the closest-pair tile): a replicated point
store would defeat the backend, so nothing is replicated.
"""
from __future__ import annotations

__all__ = ["shard_rows", "index_row_split"]


def shard_rows(n: int, shards: int, multiple: int = 1) -> int:
    """Rows a shard holds for n rows over ``shards``: ⌈max(n, 1)/P⌉
    rounded up to a multiple of ``multiple``."""
    if shards < 1 or multiple < 1:
        raise ValueError(f"shards and multiple must be >= 1, got {shards}, {multiple}")
    nl = -(-max(n, 1) // shards)
    return -(-nl // multiple) * multiple


def index_row_split(n: int, shards: int, multiple: int = 1) -> list[slice]:
    """The padded rows each shard holds: shard p holds rows
    ``[p·nl, (p+1)·nl)`` of the P·nl padded rows; rows ≥ n are padding."""
    nl = shard_rows(n, shards, multiple)
    return [slice(p * nl, (p + 1) * nl) for p in range(shards)]
