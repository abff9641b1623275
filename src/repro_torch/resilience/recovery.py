"""Durability orchestration: WAL-before-memory logging + recovery (the
port of ``repro.resilience.recovery``).

:class:`DurabilityManager` is the piece StreamingIndex owns when built
with ``options={"durability": {"dir": ...}}``.  The contract:

    log(op)  →  [chaos: stream.apply]  →  mutate memory

Every mutation appends its WAL record (fsynced by default) BEFORE the
in-memory state changes, so the durable log prefix always dominates
memory: a crash at any point loses at most the single op whose record
never hit the disk.  Snapshots bound replay length — every
``snapshot_every`` records the manager writes an atomic snapshot
(:mod:`repro.resilience.snapshot`) and rotates the WAL to a fresh
file whose base LSN starts past the snapshot.

``recover(dir)`` rebuilds an index from disk alone, on the card unless
the caller asks for the CPU:

    1. scan the WAL; a torn tail (first bad record onward) is
       physically truncated — torn bytes are NEVER replayed;
    2. load + checksum-verify the newest committed snapshot (a
       corrupt snapshot raises CorruptSegmentError — refusal, not
       best-effort);
    3. replay WAL records with lsn > snapshot lsn through the normal
       insert/delete/flush code paths (auto-flush and compaction are
       deterministic functions of the op sequence, so derived "flush"
       and "compact" records replay as no-ops);
    4. re-attach a DurabilityManager continuing at the next LSN.

Replay equivalence — the recovered index's ``live_ids`` and search
results match a never-crashed twin exactly — is what the kill-point
sweep holds.  The files are the reference's: its ``recover`` reads a
directory this module wrote, and this one reads the reference's (pass
the reference family's ``a`` to get its answers).
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from . import _msgpack as msgpack
from .fsio import fsync_dir, write_file_durable
from .snapshot import (CorruptSegmentError, latest_snapshot, load_snapshot,
                       write_snapshot)
from .wal import WriteAheadLog, scan_wal, truncate_wal

__all__ = ["DurabilityManager", "RecoveryReport", "RecoveryError", "recover"]

_WAL_NAME = "wal.log"
_CONFIG_NAME = "config.msgpack"


class RecoveryError(RuntimeError):
    """The WAL and snapshot disagree — replay cannot proceed safely."""


class RecoveryReport:
    """What ``recover`` did: replay volume, verification, wall time."""

    def __init__(self, *, snapshot_lsn: int | None, records_replayed: int,
                 records_skipped: int, torn_bytes_truncated: int,
                 bytes_verified: int, wall_seconds: float):
        self.snapshot_lsn = snapshot_lsn  # None = no snapshot, full replay
        self.records_replayed = records_replayed
        self.records_skipped = records_skipped  # lsn <= snapshot (already in)
        self.torn_bytes_truncated = torn_bytes_truncated
        self.bytes_verified = bytes_verified  # snapshot payload bytes checked
        self.wall_seconds = wall_seconds

    def __repr__(self) -> str:
        return (f"RecoveryReport(snapshot_lsn={self.snapshot_lsn}, "
                f"replayed={self.records_replayed}, "
                f"skipped={self.records_skipped}, "
                f"torn_bytes={self.torn_bytes_truncated}, "
                f"verified_bytes={self.bytes_verified}, "
                f"wall={self.wall_seconds:.3f}s)")


def _thaw(value: Any) -> Any:
    """FrozenOptions/tuples → plain dict/list (msgpack-serializable)."""
    if isinstance(value, Mapping):
        return {k: _thaw(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_thaw(v) for v in value]
    return value


def _metrics():
    from ..obs.metrics import get_registry

    reg = get_registry()
    return {
        "fsync": reg.histogram(
            "wal_fsync_seconds", "per-append WAL fsync latency"),
        "records": reg.counter(
            "wal_records_total", "WAL records appended by op",
            labels=("op",)),
        "replayed": reg.counter(
            "recovery_replayed_total", "WAL records replayed by recover()"),
        "snapshots": reg.counter(
            "snapshot_commits_total", "atomic snapshots committed"),
    }


class DurabilityManager:
    """WAL + snapshot lifecycle for one StreamingIndex directory."""

    def __init__(self, directory: str | os.PathLike, *, d: int,
                 config=None, sync: bool = True, snapshot_every: int = 0,
                 snapshot_keep: int = 2, fresh: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        if fresh:
            # a fresh build must not silently append onto an existing
            # durable index — that history belongs to recover()
            wal_path = self.dir / _WAL_NAME
            has_history = latest_snapshot(self.dir) is not None
            if not has_history and wal_path.exists():
                try:
                    has_history = bool(scan_wal(wal_path)[1])
                except ValueError:
                    has_history = True
            if has_history:
                raise RecoveryError(
                    f"{self.dir} already holds a durable index; recover "
                    "it with repro_torch.resilience.recover() or point "
                    "durability at an empty directory")
        self.sync = bool(sync)
        self.snapshot_every = int(snapshot_every)  # 0 = manual only
        self.snapshot_keep = max(int(snapshot_keep), 1)
        self.records_since_snapshot = 0
        self._m = _metrics()
        # persist (config, d, durability settings) so recover(dir) is
        # self-contained — no caller-side config plumbing on restart
        cfg_path = self.dir / _CONFIG_NAME
        if config is not None and not cfg_path.exists():
            opts = {k: _thaw(v) for k, v in config.options.items()
                    if k != "durability"}
            write_file_durable(cfg_path, msgpack.packb({
                "d": int(d),
                "config": {
                    "backend": config.backend, "c": config.c,
                    "cp_c": config.cp_c, "m": config.m,
                    "seed": config.seed, "default_k": config.default_k,
                    "options": opts,
                },
                "durability": {"sync": self.sync,
                               "snapshot_every": self.snapshot_every,
                               "snapshot_keep": self.snapshot_keep},
            }))
            fsync_dir(self.dir)
        self.wal = WriteAheadLog(
            self.dir / _WAL_NAME, sync=self.sync,
            fsync_observer=self._m["fsync"].observe)

    # -- logging (call BEFORE the in-memory mutation) --------------------

    def _append(self, payload: dict) -> int:
        lsn = self.wal.append(payload)
        self._m["records"].inc(op=payload["op"])
        self.records_since_snapshot += 1
        return lsn

    def log_insert(self, id0: int, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, dtype=np.float32)
        return self._append({"op": "insert", "id0": int(id0),
                             "n": int(x.shape[0]), "d": int(x.shape[1]),
                             "vec": x.tobytes()})

    def log_delete(self, ids: np.ndarray) -> int:
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        return self._append({"op": "delete", "ids": ids.tobytes()})

    def log_flush(self) -> int:
        return self._append({"op": "flush"})

    def log_compact(self) -> int:
        return self._append({"op": "compact"})

    # -- snapshots -------------------------------------------------------

    def maybe_snapshot(self, index) -> Path | None:
        if (self.snapshot_every > 0
                and self.records_since_snapshot >= self.snapshot_every):
            return self.snapshot(index)
        return None

    def snapshot(self, index) -> Path:
        """Snapshot ``index`` as of the last applied record, rotate the
        WAL past it, and GC old snapshots.  Crash-safe at every step:
        before the COMMIT the old snapshot+WAL still recover; between
        COMMIT and rotation the WAL's overlap with the snapshot is
        skipped at replay (lsn <= snapshot lsn)."""
        last_lsn = self.wal.next_lsn - 1
        path = write_snapshot(self.dir, index, last_lsn)
        self._m["snapshots"].inc()
        self._rotate(self.wal.next_lsn)
        self.records_since_snapshot = 0
        self._gc(keep=self.snapshot_keep)
        return path

    def _rotate(self, base_lsn: int) -> None:
        self.wal.close()
        wal_path = self.dir / _WAL_NAME
        tmp = self.dir / (_WAL_NAME + ".new")
        tmp.unlink(missing_ok=True)  # a crashed rotation may have left one
        fresh = WriteAheadLog(tmp, base_lsn=base_lsn, sync=self.sync)
        fresh.close()
        os.replace(tmp, wal_path)
        fsync_dir(self.dir)
        self.wal = WriteAheadLog(wal_path, sync=self.sync,
                                 fsync_observer=self._m["fsync"].observe)

    def _gc(self, keep: int) -> None:
        import shutil

        from .snapshot import _PREFIX, snapshot_lsn

        snaps = sorted((p for p in self.dir.iterdir()
                        if p.is_dir() and p.name.startswith(_PREFIX)),
                       key=lambda p: (p.name.endswith(".tmp"),
                                      snapshot_lsn(p.with_suffix(""))
                                      if p.name.endswith(".tmp")
                                      else snapshot_lsn(p)))
        committed = [p for p in snaps if not p.name.endswith(".tmp")]
        stale = ([p for p in snaps if p.name.endswith(".tmp")]
                 + committed[:-keep])
        for p in stale:
            shutil.rmtree(p, ignore_errors=True)

    def close(self) -> None:
        self.wal.close()


# -- recovery ---------------------------------------------------------------


def load_config(directory: str | os.PathLike) -> dict:
    """The persisted (config, d, durability) block for ``directory``."""
    path = Path(directory) / _CONFIG_NAME
    if not path.exists():
        raise RecoveryError(f"{directory}: no {_CONFIG_NAME} — not a "
                            "durability directory")
    return msgpack.unpackb(path.read_bytes())


def recover(directory: str | os.PathLike, *,
            device: str | torch.device = "cuda", a: np.ndarray | None = None):
    """Rebuild a StreamingIndex from ``directory`` after a crash.

    Returns ``(index, RecoveryReport)``.  The index is built on
    ``device`` (the card unless the caller asks for the CPU; without
    CUDA the default raises) and comes back with a live
    DurabilityManager attached, continuing the WAL at the next LSN.
    ``a`` (d, m) is the projection its segments use, e.g. the JAX
    family's, as ``StreamingIndex.from_arrays`` takes it; None draws A
    from the persisted seed, as ``build_index`` does.  Raises
    :class:`CorruptSegmentError` if the newest committed snapshot fails
    verification and :class:`RecoveryError` if the WAL contradicts the
    snapshot.
    """
    from ..index.config import IndexConfig
    from ..stream.index import StreamingIndex

    t0 = time.perf_counter()
    device = resolve_device(device)
    directory = Path(directory)
    blob = load_config(directory)
    d = int(blob["d"])
    cfg = blob["config"]
    config = IndexConfig(backend=cfg["backend"], c=cfg["c"],
                         cp_c=cfg["cp_c"], m=cfg["m"], seed=cfg["seed"],
                         default_k=cfg["default_k"],
                         options=cfg.get("options", {}))
    dur = blob.get("durability", {})

    # 1. WAL scan + torn-tail truncation
    wal_path = directory / _WAL_NAME
    records, torn = [], 0
    if wal_path.exists():
        _, records, valid = scan_wal(wal_path)
        torn = wal_path.stat().st_size - valid
        if torn:
            truncate_wal(wal_path, valid)

    # 2. newest committed snapshot (verified; refusal raises)
    snap_path = latest_snapshot(directory)
    state = load_snapshot(snap_path) if snap_path is not None else None
    if state is not None and state.d != d:
        raise RecoveryError(f"snapshot d={state.d} != config d={d}")

    # 3. empty index, snapshot applied, WAL tail replayed
    index = StreamingIndex(np.empty((0, d), dtype=np.float32), config,
                           device=device, a=a)
    if state is not None:
        _apply_snapshot(index, state)
    snap_lsn = state.lsn if state is not None else None
    replayed = skipped = 0
    for rec in records:
        if snap_lsn is not None and rec.lsn <= snap_lsn:
            skipped += 1
            continue
        _apply_record(index, rec)
        replayed += 1
    _metrics()["replayed"].inc(replayed)

    # 4. continue the WAL where it left off
    index.durability = DurabilityManager(
        directory, d=d, config=None, sync=bool(dur.get("sync", True)),
        snapshot_every=int(dur.get("snapshot_every", 0)),
        snapshot_keep=int(dur.get("snapshot_keep", 2)))
    index.durability.records_since_snapshot = replayed

    report = RecoveryReport(
        snapshot_lsn=snap_lsn, records_replayed=replayed,
        records_skipped=skipped, torn_bytes_truncated=torn,
        bytes_verified=state.bytes_verified if state is not None else 0,
        wall_seconds=time.perf_counter() - t0)
    return index, report


def _apply_snapshot(index, state) -> None:
    """Install verified snapshot contents into a freshly built (empty)
    StreamingIndex.  Segments are rebuilt from raw rows through the
    port's ``Segment`` on the index's device, with the index's A — the
    same build the live index's seal ran over the same rows."""
    from ..device import as_tensor

    total = state.total
    index._grow_to(total)
    index._alive[:total] = state.alive
    index._total = total
    index._n_live = int(state.alive.sum())
    index.n_flushes = state.n_flushes
    index.n_compactions = state.n_compactions
    for ids, vectors in state.segments:
        index._store[ids] = vectors
        seg = index._segment(ids, as_tensor(vectors, index.device))
        seg.dead = int(ids.size - state.alive[ids].sum())
        index._owner[ids] = seg.serial
        index._by_serial[seg.serial] = seg
        index.segments.append(seg)
    if state.delta_ids.size:
        index._store[state.delta_ids] = state.delta_vectors
        index.delta.insert(state.delta_ids, state.delta_vectors)
    if index.drift is not None and index._n_live:
        live = index.live_ids()
        index.drift.observe_rows(index._store[live] @ index._a)


def _apply_record(index, rec) -> None:
    p = rec.payload
    op = p.get("op")
    if op == "insert":
        if index._total != p["id0"]:
            raise RecoveryError(
                f"WAL record lsn={rec.lsn} inserts at id {p['id0']} but "
                f"index has assigned {index._total} ids — log and "
                "snapshot disagree")
        x = np.frombuffer(p["vec"], dtype=np.float32).reshape(p["n"], p["d"])
        index.insert(x)
    elif op == "delete":
        ids = np.frombuffer(p["ids"], dtype=np.int64)
        index.delete(ids)
    elif op == "flush":
        index.flush()  # no-op when replayed inserts already auto-flushed
    elif op == "compact":
        pass  # derived event: compaction re-fires inside delete/flush
    else:
        raise RecoveryError(f"unknown WAL op {op!r} at lsn={rec.lsn}")
