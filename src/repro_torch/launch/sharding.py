"""Layouts over the mesh, the counterparts of ``repro.launch.sharding``:
the row split of the sharded index's arrays (``index_row_pspec`` /
``index_shardings``), the LM's batch and cache specs (``batch_pspecs`` /
``cache_pspecs``) and its parameter specs (``param_pspecs``, with the
per-layer view ``layer_layouts`` that the model steps execute).

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

import dataclasses
import math

from .mesh import axis_size, dp_axes

__all__ = ["LeafLayout", "batch_pspecs", "cache_pspecs", "index_row_split", "layer_layouts",
           "local_block", "local_shape", "param_pspecs", "shard_rows", "split_dims"]


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


def cache_pspecs(cache_specs_tree, mesh, *, batch: int, max_seq: int,
                 seq_split: bool = True):
    """The cache's specs, the reference's rule leaf by leaf: k / v / pk /
    ck / cv (·, B, S, KV, hd|m) split B over the data-parallel axes when
    it divides them, else the SEQUENCE over ('data', 'model') when S
    divides both, else over 'data' (the distributed PM-LSH layout);
    heads, or else the width of a cache whose sequence is whole, over
    'model'.  Recurrent states split their batch dimension (after a
    stacked ``unit`` dimension) and the RG-LRU's width over 'model'.
    ``seq_split=False`` keeps every sequence whole (the layout of a
    decode that is not the sequence-sharded one).  ``batch`` and
    ``max_seq`` are accepted for the reference's signature."""
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
            elif seq_split and S % (data * model) == 0:
                # batch 1: the KEY SEQUENCE over both axes, the tournament
                # merge over the combined axis
                s[-3] = ("data", "model")
                seq_sharded = seq_uses_model = True
            elif seq_split and S % data == 0:
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


# ---------------------------------------------------------------------------
# the LM's parameters
# ---------------------------------------------------------------------------

# base (unstacked) rank and the template of each dimension, by leaf name:
# Megatron-style TP over 'model' (q/k/v and up column-parallel, o and
# down row-parallel, the vocabulary split, experts split: EP)
_RULES: dict[str, tuple[int, tuple]] = {
    # embeddings
    "embed": (2, ("model", None)),
    "lm_head": (2, (None, "model")),
    # attention
    "wq": (2, (None, "model")),
    "wk": (2, (None, "model")),
    "wv": (2, (None, "model")),
    "wo": (2, ("model", None)),
    "lsh_a": (2, (None, None)),
    # mlps
    "w_gate": (2, (None, "model")),
    "w_up": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    "w_in": (2, (None, "model")),
    "w_out": (2, ("model", None)),
    # moe (batched expert weights; leading dim = experts → EP)
    "router": (2, (None, None)),
    "moe/w_gate": (3, ("model", None, None)),
    "moe/w_up": (3, ("model", None, None)),
    "moe/w_down": (3, ("model", None, None)),
    # rg-lru
    "w_y": (2, (None, "model")),
    "w_x": (2, (None, "model")),
    "conv_w": (2, (None, "model")),
    "w_a": (3, ("model", None, None)),
    "w_i": (3, ("model", None, None)),
    "lam": (1, ("model",)),
    # xlstm
    "w_z": (2, (None, "model")),
    "w_q": (2, (None, "model")),
    "w_f": (2, (None, None)),
    "b_f": (1, (None,)),
    "b_i": (1, (None,)),
    "w_o": (2, (None, "model")),
    # norms
    "ln1": (1, (None,)),
    "ln2": (1, (None,)),
    "ln3": (1, (None,)),
    "lnx": (1, (None,)),
    "final_norm": (1, (None,)),
    "enc_norm": (1, (None,)),
}


def _path_names(path) -> list[str]:
    return [str(p) for p in path]


def _param_rule(names: list[str], ndim: int) -> tuple:
    """The template of a leaf at ``names`` of rank ``ndim`` (stacked
    dimensions included): the rule's dimensions after one ``None`` per
    dimension past the rule's rank.  The rank-3 MoE rule is picked by
    ``ndim >= 3`` and so by a scan-stacked dense leaf under ``moe`` too
    (qwen2-moe's shared expert), as the reference picks it."""
    name = names[-1] if names else ""
    key = name
    if name in ("w_gate", "w_up", "w_down") and "moe" in names and ndim >= 3:
        key = f"moe/{name}"
    if name in ("w_i",) and ndim >= 2 and "mlstm" in names:
        key = "w_f"  # xlstm input gate (d, H) — replicate
    rule = _RULES.get(key)
    if rule is None:
        return ()
    rank, dims = rule
    extra = ndim - rank  # stacked scan dims
    if extra < 0:
        return ()
    return (None,) * extra + dims


def _respect_divisibility(spec: tuple, shape, mesh) -> tuple:
    """Each entry whose axes do not divide its dimension is replaced by
    ``None`` (replicated)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(None if rule is None or dim % _axes_size(mesh, rule) else rule
                 for dim, rule in zip(shape, spec))


def _add_fsdp(spec: tuple, shape, mesh, min_size: int) -> tuple:
    """ZeRO-3 / FSDP: a leaf of at least ``min_size`` elements is also
    split over the data-parallel axes on its largest free dimension that
    they divide (the first such in order of size, ties by position)."""
    if math.prod(shape) < min_size:
        return spec
    dp = dp_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in dp)
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if dims[i] is None and shape[i] % dp_size == 0:
            return dims[:i] + (_entry(dp),) + dims[i + 1:]
    return spec


def param_pspecs(abstract_params, mesh, *, fsdp: bool = False,
                 fsdp_min_size: int = 1 << 20):
    """The spec of every leaf of the reference's STACKED parameter tree
    (``convert.lm_params_to_tree`` of the abstract parameters: dicts,
    tuples and meta tensors), the reference's rules leaf by leaf: the
    name's template, replicated where the axes do not divide, then with
    ``fsdp`` the data-parallel split."""

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        spec = _respect_divisibility(_param_rule(names, len(shape)), shape, mesh)
        if fsdp:
            spec = _add_fsdp(spec, shape, mesh, fsdp_min_size)
        return spec

    return _map_with_path(rule, abstract_params)


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How one of the port's parameters (one layer's leaf) lies on a
    mesh: its whole ``shape``, the ``spec`` of that per-layer leaf, and,
    where the reference's spec splits the scan-stacked layer dimension,
    ``layer_axes`` (that entry) with ``owner``, the shard along those
    axes that holds this layer whole (layers ``[s·n/k, (s+1)·n/k)`` of
    the n stacked ones on shard s of k)."""

    name: str
    shape: tuple[int, ...]
    spec: tuple
    layer_axes: object = None
    owner: int = 0

    def axes(self) -> tuple[str, ...]:
        """Every axis name the leaf is split over, the layer split's too."""
        out = []
        for e in self.spec + (self.layer_axes,):
            out += [] if e is None else [e] if isinstance(e, str) else list(e)
        return tuple(out)

    def local_shape(self, mesh) -> tuple[int, ...]:
        """The block a shard that holds this layer keeps."""
        return local_shape(self.shape, self.spec, mesh)

    def dim_of(self, axis: str) -> int | None:
        """The dimension of the per-layer leaf split over ``axis``."""
        for i, e in enumerate(self.spec):
            if e == axis or (isinstance(e, tuple) and axis in e):
                return i
        return None


def _layer_leaves(cfg, tree, specs) -> list[tuple[str, object, tuple, int | None, int]]:
    """(port name, meta leaf, stacked spec, stacked index or None,
    stacked count) for every per-layer leaf of ``cfg``'s stacked tree
    and its spec tree."""
    from ..models.transformer import layer_plan

    out = []

    def walk(node, spec, name, take=None, n=0):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], spec[k], f"{name}{k}.", take, n)
        else:
            out.append((name[:-1], node, spec, take, n))

    for k in tree:
        if k not in ("unit", "rest", "encoder", "decoder"):
            walk(tree[k], specs[k], f"{k}.")
    if cfg.family == "encdec":
        for part, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.n_layers)):
            for i in range(n):
                walk(tree[part], specs[part], f"{part}.{i}.", i, n)
        return out
    unit, n_units, _ = layer_plan(cfg)
    for j, block in enumerate(tree["unit"]):
        for u in range(n_units):
            walk(block, specs["unit"][j], f"blocks.{u * len(unit) + j}.", u, n_units)
    for i, block in enumerate(tree["rest"]):
        walk(block, specs["rest"][i], f"blocks.{n_units * len(unit) + i}.")
    return out


def layer_layouts(cfg, mesh, *, fsdp: bool = False, fsdp_min_size: int = 1 << 20
                  ) -> dict[str, LeafLayout]:
    """The per-layer view of :func:`param_pspecs`: one
    :class:`LeafLayout` for each of the port's ``named_parameters()``.
    The specs are computed on the reference's stacked tree (its shapes
    from ``convert.lm_params_to_tree`` on the meta device) and mapped to
    the port's one-module-a-layer leaves: a stacked leaf's spec loses its
    leading entry, which, where it splits the layers, becomes
    ``layer_axes`` and the layer's ``owner``."""
    from ..convert import lm_params_to_tree
    from ..models import model_module

    tree = lm_params_to_tree(cfg, model_module(cfg).abstract_params(cfg))
    specs = param_pspecs(tree, mesh, fsdp=fsdp, fsdp_min_size=fsdp_min_size)
    out = {}
    for name, leaf, spec, take, n in _layer_leaves(cfg, tree, specs):
        if take is None:
            out[name] = LeafLayout(name, tuple(leaf.shape), spec)
            continue
        lead = spec[0]
        owner = 0 if lead is None else take // (n // _axes_size(mesh, lead))
        out[name] = LeafLayout(name, tuple(leaf.shape[1:]), spec[1:], lead, owner)
    return out


def local_block(t, layout: LeafLayout, mesh, coords: tuple[int, int]):
    """The block of a whole leaf ``t`` that the shard at ``coords`` (its
    (data, model) coordinates on ``mesh``) holds under ``layout``: a
    contiguous copy, or an empty tensor where another shard holds the
    layer."""
    at_axis = dict(zip(("data", "model"), coords))

    def index(names) -> tuple[int, int]:
        n, at = 1, 0
        for a in names:
            n, at = n * axis_size(mesh, a), at * axis_size(mesh, a) + at_axis[a]
        return n, at

    def names_of(e) -> tuple:
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    if layout.layer_axes is not None and index(names_of(layout.layer_axes))[1] != layout.owner:
        return t.new_empty((0,))
    for dim, e in enumerate(layout.spec):
        n, at = index(names_of(e))
        if n > 1:
            b = t.shape[dim] // n
            t = t.narrow(dim, at * b, b)
    t = t.contiguous()
    # a block narrowed on its leading dimension is contiguous already but
    # a view of the whole leaf's storage: copy it, so the shard holds its
    # block alone
    return t.clone() if t.untyped_storage().nbytes() > t.numel() * t.element_size() else t
