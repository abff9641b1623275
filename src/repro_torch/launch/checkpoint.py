"""Fault-tolerant checkpointing, the port of ``repro.launch.checkpoint``,
in the reference's layout so that either framework restores what the
other wrote:

    <dir>/step_<N>/
        manifest.msgpack   — step, leaf count, a tree description, each
                             leaf's dtype and shape, ``extra``
        shard_0.npz        — the leaves ``leaf_<i>``, flattened
        COMMIT             — written LAST; a checkpoint without it is
                             incomplete and ignored on restore

A tree is nested dicts, tuples and lists whose leaves are tensors or
numpy arrays; its leaves go in ``jax.tree.flatten``'s order (dict keys
sorted, sequences in order, ``None`` holding no leaf).  bfloat16 is
stored as its uint16 bits.  The manifest is packed by the port's own
msgpack subset (``resilience._msgpack``); its ``treedef`` string is the
port's description, which neither framework's ``restore`` reads.  An
LM's state goes in as the reference's stacked tree
(``convert.lm_params_to_tree``, ``launch.train.TrainLoop.state_tree``).

Fault-tolerance properties:
  * atomic commit through :func:`repro_torch.resilience.fsio.commit_dir`
    (payload fsynced, then the COMMIT marker, then the rename);
  * :class:`AsyncCheckpointer` serializes on a background thread, at
    most one save pending; it copies the tree to the host before it
    returns (unless handed host leaves the caller owns), since the
    train step updates the parameters in place;
  * ``restore`` places each leaf on the device it is asked for;
  * ``latest_step`` scans for the newest COMMITted step (crash restart).
"""
from __future__ import annotations

import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..resilience import _msgpack
from .sharding import LeafLayout, local_block
from ..resilience.fsio import commit_dir


def _flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, structure) in ``jax.tree.flatten``'s order."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [x for leaves, _ in parts for x in leaves], ("dict", keys, [s for _, s in parts])
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, None, [s for _, s in parts]))
    return [tree], "*"


def _specs_like(like: Any, specs: Any) -> list:
    """The spec of each of ``like``'s leaves, in :func:`_flatten`'s order
    (a spec is a tuple, so the walk follows ``like``'s structure)."""
    if like is None:
        return []
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _specs_like(like[k], specs[k])]
    if isinstance(like, (tuple, list)):
        return [x for a, b in zip(like, specs) for x in _specs_like(a, b)]
    return [specs]


def _unflatten(structure: Any, leaves) -> Any:
    if structure is None:
        return None
    if structure == "*":
        return next(leaves)
    kind, keys, subs = structure
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in zip(keys, subs)}
    items = [_unflatten(s, leaves) for s in subs]
    return tuple(items) if kind == "tuple" else items


def _describe(structure: Any) -> str:
    if structure is None:
        return "None"
    if structure == "*":
        return "*"
    kind, keys, subs = structure
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(s)}" for k, s in zip(keys, subs)) + "}"
    inner = ", ".join(_describe(s) for s in subs)
    return f"({inner})" if kind == "tuple" else f"[{inner}]"


def _leaf_to_np(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.dtype).removeprefix("torch.")
    arr = np.asarray(x)
    dt = str(arr.dtype)
    if dt == "bfloat16":  # an ml_dtypes array (the reference's)
        arr = arr.view(np.uint16)
    return arr, dt


def _np_to_leaf(arr: np.ndarray, dt: str, device: torch.device) -> torch.Tensor:
    if dt == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _host_copy(tree: Any) -> Any:
    """The tree with every leaf copied to host memory (tensors stay
    tensors, so a bfloat16 leaf keeps its dtype)."""
    leaves, structure = _flatten(tree)
    host = [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else np.array(x)
            for x in leaves]
    return _unflatten(structure, iter(host))


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None) -> Path:
    """Synchronous save with atomic commit."""
    base = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = base.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, structure = _flatten(tree)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        arr, dt = _leaf_to_np(leaf)
        arrays[f"leaf_{i}"] = arr
        meta.append({"dtype": dt, "shape": list(arr.shape)})
    np.savez(tmp / "shard_0.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": _describe(structure),
        "leaves": meta,
        "extra": extra or {},
    }
    (tmp / "manifest.msgpack").write_bytes(_msgpack.packb(manifest))
    if base.exists():
        shutil.rmtree(base)
    return commit_dir(tmp, base)


class AsyncCheckpointer:
    """Background-thread checkpointing with at most one pending save."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None, *, copy: bool = True):
        """Writes ``tree`` as ``step`` on the background thread.  With
        ``copy`` its leaves are first copied to host memory, since the
        train step updates tensors in place; ``copy=False`` takes a tree
        of host leaves the caller owns and will not change (the train
        loop's ``state_tree``, one copy already)."""
        self.wait()  # double-buffer: block if a save is still running
        host_tree = _host_copy(tree) if copy else tree  # snapshot before returning

        def work():
            try:
                save(self.dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(committed_steps(self.dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)


def committed_steps(ckpt_dir: str | os.PathLike) -> list[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return []
    out = []
    for p in base.iterdir():
        if p.name.startswith("step_") and (p / "COMMIT").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | os.PathLike, step: int, like: Any, *,
            device: str | torch.device = "cuda", shardings: Any | None = None,
            mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (its leaves' values are not
    read), each leaf a tensor on ``device`` in its stored dtype.  With
    ``shardings`` (a tree of specs shaped as ``like``, e.g.
    ``launch.sharding.param_pspecs`` of the reference's stacked tree) and
    a process group's ``mesh``, each leaf is the block this rank holds —
    any mesh, whatever the mesh that wrote it, as the reference's
    ``restore(..., shardings)`` remeshes; emulated meshes hold leaves
    whole.  Returns (tree, extra)."""
    dev = resolve_device(device)
    base = Path(ckpt_dir) / f"step_{step:08d}"
    if not (base / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {base}")
    manifest = _msgpack.unpackb((base / "manifest.msgpack").read_bytes())
    try:
        data = np.load(base / "shard_0.npz")
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise RuntimeError(
            f"checkpoint {base} is committed but its shard payload is "
            f"unreadable ({e}); the checkpoint predates durable commits "
            f"or the disk corrupted it — fall back to an older step"
        ) from e
    leaves_like, structure = _flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target structure "
            f"has {len(leaves_like)} — incompatible trees"
        )
    specs = None
    if shardings is not None and mesh is not None and not mesh.emulated:
        specs = _specs_like(like, shardings)
        if len(specs) != len(leaves_like):
            raise ValueError(f"{len(specs)} specs for {len(leaves_like)} leaves")
    with data:
        out = []
        for i, meta in enumerate(manifest["leaves"]):
            leaf = _np_to_leaf(data[f"leaf_{i}"], meta["dtype"], dev)
            if specs is not None and specs[i]:
                leaf = local_block(leaf, LeafLayout("", tuple(leaf.shape), tuple(specs[i])),
                                   mesh, mesh.coords)
            out.append(leaf)
    return _unflatten(structure, iter(out)), manifest.get("extra", {})
