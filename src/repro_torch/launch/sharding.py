"""Layouts over the mesh, the counterparts of ``repro.launch.sharding``:
the row split of the sharded index's arrays (``index_row_pspec`` /
``index_shardings``) and the LM's batch and cache specs
(``batch_pspecs`` / ``cache_pspecs``).

Every index array (points, projections, codes, the closest-pair blocks)
is split by rows over the mesh's P shards, trailing dimensions whole.
The rows are first padded so that each shard holds the same count, a
multiple of ``multiple`` (the closest-pair tile): a replicated point
store would defeat the backend, so nothing is replicated.

The LM's specs are pure functions of shapes and axis sizes: a mesh is
anything with ``axis_names`` and ``shape`` (a :class:`~.mesh.HostMesh`,
or a stand-in for a production mesh), and a spec is a tuple with one
entry a dimension, each ``None`` (whole), an axis name, or a tuple of
names — the entries of the reference's ``PartitionSpec``, a one-name
tuple written as the name, as ``PartitionSpec`` normalises it.
:func:`split_dims` and :func:`local_shape` read a spec as the reference's
``NamedSharding`` does: which dimension is split over how many shards,
and the block one shard holds.
"""
from __future__ import annotations

import math

from .mesh import axis_size, dp_axes

__all__ = ["batch_pspecs", "cache_pspecs", "index_row_split", "local_shape", "shard_rows",
           "split_dims"]


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


# ---------------------------------------------------------------------------
# the LM's batches and caches
# ---------------------------------------------------------------------------


def _entry(axes):
    """A spec entry for ``axes`` (a name or a tuple of names)."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(axis_size(mesh, a) for a in names)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def batch_pspecs(batch_specs: dict, mesh) -> dict:
    """tokens/labels (B, S): B over the data-parallel axes when it
    divides them, else replicated; modality embeds too.  Scalars
    replicate."""
    dp = dp_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)

    def rule(leaf):
        if len(leaf.shape) == 0:
            return ()
        lead = _entry(dp) if leaf.shape[0] % dp_size == 0 else None
        return (lead,) + (None,) * (len(leaf.shape) - 1)

    return {k: rule(v) for k, v in batch_specs.items()}


def cache_pspecs(cache_specs_tree, mesh, *, batch: int, max_seq: int):
    """The cache's specs, the reference's rule leaf by leaf: k / v / pk /
    ck / cv (·, B, S, KV, hd|m) split B over the data-parallel axes when
    it divides them, else the SEQUENCE over ('data', 'model') when S
    divides both, else over 'data' (the distributed PM-LSH layout);
    heads, or else the width of a cache whose sequence is whole, over
    'model'.  Recurrent states split their batch dimension (after a
    stacked ``unit`` dimension) and the RG-LRU's width over 'model'.
    ``batch`` and ``max_seq`` are accepted for the reference's
    signature."""
    del batch, max_seq
    dp = dp_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")

    def rule(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        stacked = 1 if "unit" in names else 0  # a scan-stacked leading dim
        s: list = [None] * len(shape)
        if name in ("k", "v", "pk", "ck", "cv"):
            B, S = shape[-4], shape[-3]
            seq_sharded = seq_uses_model = False
            if B % dp_size == 0:
                s[-4] = _entry(dp)
            elif S % (data * model) == 0:
                # batch 1: the KEY SEQUENCE over both axes, the tournament
                # merge over the combined axis
                s[-3] = ("data", "model")
                seq_sharded = seq_uses_model = True
            elif S % data == 0:
                s[-3] = "data"
                seq_sharded = True
            if shape[-2] % model == 0 and not seq_uses_model:
                s[-2] = "model"
            elif shape[-1] % model == 0 and not seq_sharded:
                s[-1] = "model"
            return tuple(s)
        if name in ("h", "conv", "C", "n", "c"):
            if shape[stacked] % dp_size == 0:
                s[stacked] = _entry(dp)
            if shape[-1] % model == 0 and name in ("h", "conv"):
                s[-1] = "model"
            return tuple(s)
        return ()

    return _map_with_path(rule, cache_specs_tree)


def split_dims(spec: tuple, mesh) -> dict[int, int]:
    """{dimension: shards} of the dimensions ``spec`` splits over more
    than one shard of ``mesh``."""
    sizes = {i: _axes_size(mesh, e) for i, e in enumerate(spec)}
    return {i: n for i, n in sizes.items() if n > 1}


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple[int, ...]:
    """The block of a leaf of ``shape`` laid out by ``spec`` that one
    shard holds; a split dimension must divide."""
    out = list(shape)
    for i, n in split_dims(spec, mesh).items():
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not split over {n} shards")
        out[i] //= n
    return tuple(out)
