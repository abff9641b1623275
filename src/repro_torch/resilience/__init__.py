"""repro_torch.resilience — durability and fault tolerance (the port of
``repro.resilience``).

* **durability** (:mod:`wal`, :mod:`snapshot`, :mod:`recovery`): a
  checksummed write-ahead log + atomic COMMIT-marker snapshots for
  StreamingIndex, in the reference's file format (msgpack through the
  pure-Python subset ``_msgpack``).  WAL-before-memory ordering means a
  crash at any instant loses at most the op whose record never reached
  disk; ``recover(dir)`` replays the WAL tail over the newest verified
  snapshot on the card and reports what it did.
* **fault injection** (:mod:`chaos`): deterministic seeded FaultPlans
  over named sites — crashes, bit flips, dropped flushes.
* **circuit breaker** (:mod:`breaker`) for a serving scheduler's
  degraded tier.

Durable streaming quickstart::

    from repro_torch.index import IndexConfig, build_index
    from repro_torch.resilience import recover

    cfg = IndexConfig(backend="streaming",
                      options={"durability": {"dir": "/data/idx",
                                              "snapshot_every": 4096}})
    index = build_index(seed_rows, cfg)
    index.insert(more_rows)          # WAL'd before visible
    # ... process dies ...
    index, report = recover("/data/idx")
"""
from .breaker import CircuitBreaker
from .chaos import ChaosError, FaultPlan, FaultSpec
from .fsio import commit_dir, fsync_dir, fsync_path, write_file_durable
from .recovery import (DurabilityManager, RecoveryError, RecoveryReport,
                       recover)
from .snapshot import (CorruptSegmentError, latest_snapshot, load_snapshot,
                       write_snapshot)
from .wal import WriteAheadLog, scan_wal

__all__ = [
    "CircuitBreaker",
    "ChaosError", "FaultPlan", "FaultSpec",
    "commit_dir", "fsync_dir", "fsync_path", "write_file_durable",
    "DurabilityManager", "RecoveryError", "RecoveryReport", "recover",
    "CorruptSegmentError", "latest_snapshot", "load_snapshot",
    "write_snapshot",
    "WriteAheadLog", "scan_wal",
]
