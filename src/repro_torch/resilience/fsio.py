"""Durable filesystem primitives shared by the WAL and snapshots (the
port's copy of ``repro.resilience.fsio``).

POSIX gives no single "write this durably" call — durability is a
protocol: flush the file's bytes (``fsync`` on the fd), then flush the
DIRECTORY entry that names it (``fsync`` on the directory fd), and only
then write the marker that declares the payload complete.  Skipping any
step re-opens the classic torn-commit window: after a power loss the
marker can survive while the payload it vouches for did not.

``commit_dir`` packages the full idiom the snapshot writer
(``resilience.snapshot``) uses:

    1. fsync every payload file in the staging dir
    2. fsync the staging dir (directory entries now durable)
    3. write the COMMIT marker, fsync it, fsync the dir again
    4. rename staging → final (atomic on POSIX)
    5. fsync the parent dir (the rename itself now durable)

A reader that requires the COMMIT marker therefore never observes a
committed-but-torn payload.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["fsync_path", "fsync_dir", "write_file_durable", "commit_dir",
           "COMMIT_MARKER"]

COMMIT_MARKER = "COMMIT"


def fsync_path(path: str | os.PathLike) -> None:
    """fsync a regular file's contents to stable storage."""
    fd = os.open(os.fspath(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a directory — makes its entries (creates/renames) durable."""
    fd = os.open(os.fspath(path), os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file_durable(path: str | os.PathLike, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync the file (not the dir)."""
    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def commit_dir(tmp: str | os.PathLike, final: str | os.PathLike, *,
               marker: str = COMMIT_MARKER) -> Path:
    """Durably commit staging dir ``tmp`` as ``final``.

    Payload files are fsynced BEFORE the marker is written (closing the
    torn-commit window), the marker and directory are fsynced, and the
    staging dir is atomically renamed into place.  An existing ``final``
    is replaced only after the new payload is fully durable.  Returns
    the final path.
    """
    import shutil

    tmp, final = Path(tmp), Path(final)
    for p in sorted(tmp.rglob("*")):
        if p.is_file() and p.name != marker:
            fsync_path(p)
    fsync_dir(tmp)
    write_file_durable(tmp / marker, b"ok\n")
    fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    fsync_dir(final.parent)
    return final
