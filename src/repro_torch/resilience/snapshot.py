"""Atomic, checksummed snapshots of StreamingIndex state (the port's copy
of ``repro.resilience.snapshot``; the meta is packed by ``_msgpack``).

A snapshot is a directory ``snap_<lsn:012d>/`` committed with the
COMMIT-marker protocol from :mod:`repro_torch.resilience.fsio` (fsync files →
fsync dir → COMMIT → rename → fsync parent), so a reader that requires
the marker never sees a torn snapshot.  Contents:

    meta.msgpack    lsn, d, total, counters, per-array blake2b checksums
    seg_<i>.npz     one sealed segment: global ids + float32 rows
    delta.npz       the unsealed delta buffer (ids + rows)
    alive.npz       packed liveness bitmap over ids [0, total)
    COMMIT          written last by fsio.commit_dir

Checksums are CONTENT checksums — blake2b over each array's dtype,
shape, and raw bytes — stored in the meta and re-verified on load.  A
bit flip in array data fails the checksum; a bit flip in npz container
structure fails parsing; both surface as :class:`CorruptSegmentError`
and the snapshot is refused — recovery raises rather than serving
corrupted rows.  Segment
*backends* are not serialized: load returns raw (ids, vectors) runs and
recovery rebuilds each backend deterministically from its rows — the
same codec-per-seal discipline the live index uses, so quantized
segments come back with identical codes.

Chaos sites: ``snapshot.write`` (before payloads), ``snapshot.commit``
(before the marker), ``segment.load`` (byte transform on each payload
file read — how bit-flip injection exercises the checksums).
"""
from __future__ import annotations

import hashlib
import io
import os
import shutil
import time
from pathlib import Path

import numpy as np

from . import _msgpack as msgpack
from . import chaos
from .fsio import COMMIT_MARKER, commit_dir

__all__ = ["CorruptSegmentError", "SnapshotState", "content_checksum",
           "write_snapshot", "load_snapshot", "latest_snapshot",
           "snapshot_lsn"]

_PREFIX = "snap_"


class CorruptSegmentError(RuntimeError):
    """A snapshot payload failed verification — the structured refusal
    the recovery path raises instead of serving corrupted rows."""

    def __init__(self, path, reason: str, *, expected: str | None = None,
                 actual: str | None = None):
        self.path = Path(path)
        self.reason = reason
        self.expected = expected
        self.actual = actual
        detail = f"{self.path.name}: {reason}"
        if expected is not None:
            detail += f" (expected {expected}, got {actual})"
        super().__init__(detail)


def content_checksum(*arrays: np.ndarray) -> str:
    """blake2b hex digest over each array's dtype, shape, and bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class SnapshotState:
    """Decoded, checksum-verified snapshot contents."""

    def __init__(self, *, lsn: int, d: int, total: int, n_flushes: int,
                 n_compactions: int,
                 segments: list[tuple[np.ndarray, np.ndarray]],
                 delta_ids: np.ndarray, delta_vectors: np.ndarray,
                 alive: np.ndarray, bytes_verified: int):
        self.lsn = lsn
        self.d = d
        self.total = total
        self.n_flushes = n_flushes
        self.n_compactions = n_compactions
        self.segments = segments  # [(global ids int64, rows float32)]
        self.delta_ids = delta_ids
        self.delta_vectors = delta_vectors
        self.alive = alive  # bool, shape (total,)
        self.bytes_verified = bytes_verified


def _save_npz(path: Path, **arrays) -> str:
    np.savez(path, **arrays)
    return content_checksum(*arrays.values())


def write_snapshot(directory: str | os.PathLike, index, lsn: int) -> Path:
    """Atomically snapshot ``index`` (a StreamingIndex) as of WAL
    position ``lsn`` (the last applied record).  Returns the committed
    snapshot directory."""
    directory = Path(directory)
    final = directory / f"{_PREFIX}{lsn:012d}"
    tmp = final.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    chaos.hit("snapshot.write")

    checksums: dict[str, str] = {}
    seg_meta = []
    for i, seg in enumerate(index.segments):
        name = f"seg_{i}.npz"
        checksums[name] = _save_npz(tmp / name, ids=seg.ids,
                                    vectors=index._store[seg.ids])
        seg_meta.append({"file": name, "n": int(seg.size)})
    # the delta's rows from the host store: a snapshot reads nothing
    # back from the device
    checksums["delta.npz"] = _save_npz(
        tmp / "delta.npz", ids=index.delta.ids,
        vectors=index._store[index.delta.ids])
    total = int(index._total)
    checksums["alive.npz"] = _save_npz(
        tmp / "alive.npz", bits=np.packbits(index._alive[:total]))
    meta = {
        "format": 1,
        "lsn": int(lsn),
        "d": int(index.d),
        "total": total,
        "n_flushes": int(index.n_flushes),
        "n_compactions": int(index.n_compactions),
        "segments": seg_meta,
        "checksums": checksums,
    }
    (tmp / "meta.msgpack").write_bytes(msgpack.packb(meta))
    chaos.hit("snapshot.commit")
    return commit_dir(tmp, final)


def snapshot_lsn(path: str | os.PathLike) -> int:
    return int(Path(path).name[len(_PREFIX):])


def latest_snapshot(directory: str | os.PathLike) -> Path | None:
    """Newest COMMITted snapshot dir under ``directory`` (None if no
    snapshot has ever committed)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in directory.iterdir():
        if (p.is_dir() and p.name.startswith(_PREFIX)
                and not p.name.endswith(".tmp")
                and (p / COMMIT_MARKER).exists()):
            if best is None or snapshot_lsn(p) > snapshot_lsn(best):
                best = p
    return best


def _load_npz(path: Path, expected_checksum: str,
              names: tuple[str, ...]) -> tuple[list[np.ndarray], int]:
    """Read one payload file through the chaos transform, parse it, and
    verify its content checksum.  Returns (arrays, bytes verified)."""
    blob = path.read_bytes()
    blob = chaos.transform("segment.load", blob)
    try:
        with np.load(io.BytesIO(blob)) as z:
            arrays = [np.asarray(z[n]) for n in names]
    except Exception as e:
        raise CorruptSegmentError(path, f"unparseable payload ({e})") from e
    actual = content_checksum(*arrays)
    if actual != expected_checksum:
        raise CorruptSegmentError(path, "content checksum mismatch",
                                  expected=expected_checksum, actual=actual)
    return arrays, len(blob)


def load_snapshot(path: str | os.PathLike) -> SnapshotState:
    """Decode and VERIFY a committed snapshot.  Raises
    :class:`CorruptSegmentError` on any integrity failure — a refused
    snapshot is never partially applied."""
    t0 = time.perf_counter()
    path = Path(path)
    if not (path / COMMIT_MARKER).exists():
        raise CorruptSegmentError(path, "missing COMMIT marker "
                                        "(uncommitted or torn snapshot)")
    try:
        meta = msgpack.unpackb((path / "meta.msgpack").read_bytes())
    except Exception as e:
        raise CorruptSegmentError(path, f"unreadable meta ({e})") from e
    checksums = meta["checksums"]
    nbytes = 0

    segments = []
    for ent in meta["segments"]:
        (ids, vectors), nb = _load_npz(path / ent["file"],
                                       checksums[ent["file"]],
                                       ("ids", "vectors"))
        if ids.shape[0] != ent["n"]:
            raise CorruptSegmentError(
                path / ent["file"], "row count mismatch",
                expected=str(ent["n"]), actual=str(ids.shape[0]))
        segments.append((ids.astype(np.int64),
                         vectors.astype(np.float32, copy=False)))
        nbytes += nb
    (delta_ids, delta_vectors), nb = _load_npz(
        path / "delta.npz", checksums["delta.npz"], ("ids", "vectors"))
    nbytes += nb
    (bits,), nb = _load_npz(path / "alive.npz", checksums["alive.npz"],
                            ("bits",))
    nbytes += nb
    total = int(meta["total"])
    alive = np.unpackbits(bits)[:total].astype(bool)

    state = SnapshotState(
        lsn=int(meta["lsn"]), d=int(meta["d"]), total=total,
        n_flushes=int(meta["n_flushes"]),
        n_compactions=int(meta["n_compactions"]),
        segments=segments, delta_ids=delta_ids.astype(np.int64),
        delta_vectors=delta_vectors.astype(np.float32, copy=False),
        alive=alive, bytes_verified=nbytes)
    state.load_seconds = time.perf_counter() - t0
    return state
