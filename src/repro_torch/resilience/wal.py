"""Write-ahead log for StreamingIndex mutations (the port's copy of
``repro.resilience.wal``: the same file, byte for byte, for the same
records — the payloads are packed by ``_msgpack``, msgpack's subset).

One append-only file of checksummed, length-prefixed records.  Layout:

    header   MAGIC "PMWAL001" (8B)  |  base_lsn  <Q (8B)
    record   <IQ8s  =  payload_len (4B) | lsn (8B) | blake2b-8 digest
             followed by `payload_len` bytes of msgpack payload

The digest covers ``lsn_bytes + payload`` so a record cannot be
spliced to a different position, and the length prefix lets the reader
detect a torn tail: scanning stops at the FIRST record whose header is
incomplete, whose payload is short, or whose digest mismatches —
everything at and past that offset is presumed torn by a crash and is
truncated before the log is reopened for append (torn tails are never
replayed).

Payload dicts (op-specific):

    {"op": "insert", "id0": int, "n": int, "d": int, "vec": bytes}
        vec = raw little-endian float32, n*d values; ids are always
        the contiguous range [id0, id0+n) (StreamingIndex invariant)
    {"op": "delete", "ids": bytes}      raw little-endian int64 ids
    {"op": "flush"}                     explicit delta seal
    {"op": "compact"}                   explicit compaction request

The WAL-before-memory contract lives in the caller
(``recovery.DurabilityManager``): a record is appended (and optionally
fsynced) BEFORE the in-memory mutation, so the durable prefix of the
log always dominates the in-memory state.
"""
from __future__ import annotations

import os
import struct
import time
from pathlib import Path

from . import _msgpack as msgpack
from . import chaos
from .fsio import fsync_path

__all__ = ["WriteAheadLog", "WalRecord", "scan_wal", "MAGIC",
           "HEADER_SIZE", "RECORD_HEADER"]

MAGIC = b"PMWAL001"
RECORD_HEADER = struct.Struct("<IQ8s")  # payload_len, lsn, digest
HEADER_SIZE = len(MAGIC) + 8  # magic + base_lsn
_DIGEST_SIZE = 8


def _digest(lsn: int, payload: bytes) -> bytes:
    import hashlib

    return hashlib.blake2b(lsn.to_bytes(8, "little") + payload,
                           digest_size=_DIGEST_SIZE).digest()


class WalRecord:
    """One decoded WAL record."""

    __slots__ = ("lsn", "payload")

    def __init__(self, lsn: int, payload: dict):
        self.lsn = lsn
        self.payload = payload

    def __repr__(self):
        return f"WalRecord(lsn={self.lsn}, op={self.payload.get('op')!r})"


class WriteAheadLog:
    """Appender over one WAL file.  Not thread-safe (callers serialize,
    matching StreamingIndex's single-writer model)."""

    def __init__(self, path: str | os.PathLike, *, base_lsn: int = 0,
                 sync: bool = True, fsync_observer=None):
        """Open ``path`` for append, creating it (with a fresh header)
        if absent.  ``sync=False`` skips the per-append fsync.
        ``fsync_observer(seconds)`` feeds the wal_fsync_seconds metric.
        """
        self.path = Path(path)
        self.sync = bool(sync)
        self._fsync_observer = fsync_observer
        self.appended = 0  # records appended via this handle
        if self.path.exists() and self.path.stat().st_size >= HEADER_SIZE:
            base, records, valid = scan_wal(self.path)
            if valid < self.path.stat().st_size:
                # torn tail from a previous crash: cut it before append
                truncate_wal(self.path, valid)
            self.base_lsn = base
            self.next_lsn = records[-1].lsn + 1 if records else base
            self._f = open(self.path, "ab")
        else:
            self.base_lsn = int(base_lsn)
            self.next_lsn = self.base_lsn
            self._f = open(self.path, "wb")
            self._f.write(MAGIC + struct.pack("<Q", self.base_lsn))
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())

    def append(self, payload: dict) -> int:
        """Append one record durably; returns its LSN.  Raises before
        writing anything if a chaos fault is scheduled at wal.append
        (the pre-write kill point: the op never reached the log)."""
        chaos.hit("wal.append")
        body = msgpack.packb(payload)
        lsn = self.next_lsn
        rec = RECORD_HEADER.pack(len(body), lsn, _digest(lsn, body)) + body
        self._f.write(rec)
        self._f.flush()
        if self.sync:
            t0 = time.perf_counter()
            os.fsync(self._f.fileno())
            if self._fsync_observer is not None:
                self._fsync_observer(time.perf_counter() - t0)
        self.next_lsn = lsn + 1
        self.appended += 1
        return lsn

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scan_wal(path: str | os.PathLike) -> tuple[int, list[WalRecord], int]:
    """Sequentially decode a WAL file.

    Returns ``(base_lsn, records, valid_bytes)`` where ``valid_bytes``
    is the offset of the first torn/invalid byte (== file size when the
    log is clean).  Scanning stops at the first record that is
    incomplete, fails its digest, or breaks LSN monotonicity — a torn
    tail is DETECTED, never replayed.
    """
    data = Path(path).read_bytes()
    if len(data) < HEADER_SIZE or data[: len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a WAL file (bad magic)")
    (base_lsn,) = struct.unpack_from("<Q", data, len(MAGIC))
    records: list[WalRecord] = []
    off = HEADER_SIZE
    expect = base_lsn
    while off + RECORD_HEADER.size <= len(data):
        plen, lsn, digest = RECORD_HEADER.unpack_from(data, off)
        body_off = off + RECORD_HEADER.size
        if body_off + plen > len(data):
            break  # torn: payload ran past EOF
        body = data[body_off: body_off + plen]
        if lsn != expect or _digest(lsn, body) != digest:
            break  # torn/corrupt: stop, do not trust anything past here
        try:
            payload = msgpack.unpackb(body)
        except Exception:
            break
        records.append(WalRecord(lsn, payload))
        off = body_off + plen
        expect = lsn + 1
    return base_lsn, records, off


def truncate_wal(path: str | os.PathLike, valid_bytes: int) -> None:
    """Physically cut a torn tail so it can never be replayed."""
    with open(path, "r+b") as f:
        f.truncate(valid_bytes)
        f.flush()
        os.fsync(f.fileno())
    fsync_path(path)
