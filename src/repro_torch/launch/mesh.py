"""The 1-D data mesh of the sharded index backends, the counterpart of
``repro.launch.mesh.make_data_mesh``.

A :class:`DataMesh` lays the index's rows out over P shards along one
axis and carries the four collectives the sharded programs use: a psum
of int32 counts, a pmax of float32 values, an all-gather, and a ring
permute in which shard p receives what shard p − 1 held.  It comes in
two forms that run the same stage code:

  emulated       P shards in one process on one device.  The process
                 holds every shard's blocks; each collective is an exact
                 reduction over them in shard order 0..P−1.
  process group  a ``torch.distributed`` group with one rank per shard:
                 NCCL with rank r on ``cuda:r``, or gloo on the CPU.
                 Each process holds its own shard's blocks; the ring
                 goes through ``batch_isend_irecv``, so no ordering of
                 sends and receives can deadlock.

Stage code iterates over ``mesh.local`` (every shard when emulated, its
own rank in a group) and hands the collectives a list with one entry per
local shard; what comes back is the same in every process.  Nothing
falls back from one form to the other.

The LM side (``make_host_mesh``, ``dp_axes``, ``axis_size``) is the
reference's host mesh of ('data', 'model') axes, D × M shards.  Each
axis is a :class:`DataMesh` in one of three forms: emulated (D·M shards
in one process, every reduction in shard order), gloo ranks on the CPU
or an NCCL group of one on the card.  In a group, rank r is shard
(r // M, r % M), data-major as the reference's device array: the 'data'
axis of rank r is the column of ranks with its model coordinate, the
'model' axis the row with its data coordinate, and the combined
('data', 'model') axis the whole world.  The model steps split the
batch over 'data' (or, for a batch that does not divide it, the KV
cache's sequence) and the parameters over 'model' (tensor and expert
parallelism, ``models.parallel``).  :func:`make_production_mesh` is the
reference's production mesh as shapes and names only: it holds no
device and is the dry run's input.

A fourth form serves the dry run (``launch.dryrun``):
:func:`make_abstract_mesh` is one fixed rank of a D × M group on the
meta device, whose collectives (:class:`AbstractDataMesh`) return the
shapes a group returns and add what they move to a
:class:`CollectiveTally`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["COLLECTIVES", "AbstractDataMesh", "CollectiveTally", "DataMesh", "HostMesh",
           "ProductionMesh", "axis_size", "dp_axes", "make_abstract_mesh", "make_data_mesh",
           "make_host_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """P shards along ``axis``; ``group`` is None for the emulated form."""

    size: int
    device: torch.device
    axis: str = "data"
    group: object = None

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {self.size}")

    @property
    def emulated(self) -> bool:
        return self.group is None

    @property
    def rank(self) -> int | None:
        """This process's shard in a group, None when emulated."""
        return None if self.group is None else dist.get_rank(self.group)

    @property
    def local(self) -> tuple[int, ...]:
        """The shards whose blocks this process holds."""
        return tuple(range(self.size)) if self.group is None else (self.rank,)

    def _check(self, xs: list) -> None:
        if len(xs) != len(self.local):
            raise ValueError(f"{len(xs)} values for {len(self.local)} local shards")

    def psum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """Sum over shards (int32 counts: exact in any order)."""
        self._check(xs)
        if self.group is None:
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        out = xs[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def pmax(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over shards."""
        self._check(xs)
        if self.group is None:
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        out = xs[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard's value, in shard order."""
        self._check(xs)
        if self.group is None:
            return list(xs)
        x = xs[0].contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def ordered_sum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The float sum over shards, added in shard order 0..P−1 in
        every form (a group gathers, then adds), so it is the same bits
        emulated and in a group of any size."""
        every = self.all_gather(xs)
        out = every[0]
        for x in every[1:]:
            out = out + x
        return out

    def reduce_scatter(self, xs: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
        """:meth:`ordered_sum`, split along ``dim`` into P equal blocks:
        local shard p gets block p."""
        total = self.ordered_sum(xs)
        if total.shape[dim] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(total.shape)} does not split "
                             f"over {self.size} shards")
        blocks = total.chunk(self.size, dim=dim)
        return [blocks[p] for p in self.local]

    def broadcast(self, x: torch.Tensor, owner: int, shape: tuple) -> torch.Tensor:
        """Shard ``owner``'s tensor of ``shape`` in every process: ``x``
        itself when emulated; in a group the owner's ``x`` (a copy), the
        other ranks passing a placeholder of its dtype."""
        if self.group is None:
            return x
        out = x.clone() if self.rank == owner else torch.empty(shape, dtype=x.dtype,
                                                               device=x.device)
        dist.broadcast(out, src=dist.get_global_rank(self.group, owner), group=self.group)
        return out

    def ring(self, xs: list[tuple[torch.Tensor, ...]]) -> list[tuple[torch.Tensor, ...]]:
        """Ring permute p → p + 1 (mod P) of a tuple of tensors per shard:
        local shard p gets back what shard p − 1 sent."""
        self._check(xs)
        if self.group is None:
            return [xs[(p - 1) % self.size] for p in range(self.size)]
        if self.size == 1:
            return list(xs)
        r = self.rank
        send_to = dist.get_global_rank(self.group, (r + 1) % self.size)
        recv_from = dist.get_global_rank(self.group, (r - 1) % self.size)
        sent = tuple(t.contiguous() for t in xs[0])
        got = tuple(torch.empty_like(t) for t in sent)
        ops = [dist.P2POp(dist.isend, t, send_to, self.group) for t in sent]
        ops += [dist.P2POp(dist.irecv, t, recv_from, self.group) for t in got]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]


#: The collectives a compiled program holds, by XLA's names: what a
#: :class:`CollectiveTally` counts under.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class CollectiveTally:
    """The bytes and the count of each collective an abstract rank ran,
    under :data:`COLLECTIVES`' names.  The bytes are a collective's
    result as one rank holds it (a gather's P blocks, a reduction's one
    buffer, the tensors a ring or broadcast receives), as XLA's HLO
    gives a collective's shape; a roofline applies the wire factors."""

    def __init__(self):
        self.bytes = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += int(nbytes)
        self.counts[kind] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class AbstractDataMesh(DataMesh):
    """One fixed rank (``at``) of a process group of ``size`` on the meta
    device, for the dry run: the stage code runs that rank's program
    (``emulated`` is False, ``local`` is the rank), each collective
    returns meta tensors of the shapes a group returns and adds what the
    port's group form moves to ``tally``.  The float sums are the port's
    gathers followed by an ordered add (:meth:`DataMesh.ordered_sum`), so
    they count as all-gathers of P blocks; a collective over one shard
    moves nothing and is not counted."""

    at: int = 0
    tally: CollectiveTally = dataclasses.field(default=None, compare=False)

    @property
    def emulated(self) -> bool:
        return False

    @property
    def rank(self) -> int:
        return self.at

    @property
    def local(self) -> tuple[int, ...]:
        return (self.at,)

    def _moved(self, kind: str, nbytes: int) -> None:
        if self.size > 1:
            self.tally.add(kind, nbytes)

    def psum(self, xs: list[torch.Tensor]) -> torch.Tensor:
        self._check(xs)
        self._moved("all-reduce", _nbytes(xs[0]))
        return xs[0].clone()

    def pmax(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return self.psum(xs)

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        self._check(xs)
        x = xs[0].contiguous()
        self._moved("all-gather", self.size * _nbytes(x))
        return [torch.empty_like(x) for _ in range(self.size)]

    def broadcast(self, x: torch.Tensor, owner: int, shape: tuple) -> torch.Tensor:
        out = x.clone() if self.at == owner else torch.empty(shape, dtype=x.dtype,
                                                             device=x.device)
        self._moved("collective-permute", _nbytes(out))
        return out

    def ring(self, xs: list[tuple[torch.Tensor, ...]]) -> list[tuple[torch.Tensor, ...]]:
        self._check(xs)
        if self.size == 1:
            return list(xs)
        got = tuple(torch.empty_like(t.contiguous()) for t in xs[0])
        self._moved("collective-permute", sum(_nbytes(t) for t in got))
        return [got]


def make_abstract_mesh(data: int, model: int, coords: tuple[int, int] = (0, 0),
                       tally: CollectiveTally | None = None) -> HostMesh:
    """The rank at ``coords`` (data, model) of a ``data`` × ``model``
    group, as :class:`AbstractDataMesh` axes on the meta device: 'data'
    the column of ranks, 'model' the row, the world all D·M of them
    (rank d·M + m), every collective counted in one ``tally``."""
    d, m = coords
    if not (0 <= d < data and 0 <= m < model):
        raise ValueError(f"rank {coords} outside a ({data}, {model}) mesh")
    tally = CollectiveTally() if tally is None else tally
    meta = torch.device("meta")

    def axis(size, at, name):
        return AbstractDataMesh(size=size, device=meta, axis=name, at=at, tally=tally)

    return HostMesh(axis(data, d, "data"), axis(model, m, "model"),
                    axis(data * model, d * model + m, "data_model"))


def make_data_mesh(shards: int | None = None, axis: str = "data", *, group=None,
                   device: str | torch.device = "cuda") -> DataMesh:
    """The 1-D row mesh of the sharded backends.

    With a ``group``, or with none and the default process group
    initialised, the mesh is that group: one shard per rank, ``shards``
    (if given) equal to its size, NCCL on ``cuda:rank`` or gloo on the
    CPU (``device`` must name that device type).  Otherwise it is the
    emulated mesh of ``shards`` (default 1) shards on ``device`` (the
    meta device too: the dry run's one-device steps).
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return DataMesh(size=1 if shards is None else int(shards),
                        device=resolve_device(device, meta=True), axis=axis)
    size = dist.get_world_size(group)
    if shards is not None and int(shards) != size:
        raise ValueError(f"shards={shards} for a process group of {size} ranks; "
                         "pass emulate=True for an emulated mesh")
    backend = str(dist.get_backend(group)).lower()
    want = torch.device(device).type
    if backend == "nccl":
        if want != "cuda":
            raise ValueError(f"an NCCL group runs on the card, not on {device!r}")
        resolve_device("cuda")
        dev = torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
    elif backend == "gloo":
        if want != "cpu":
            raise ValueError(f"a gloo group runs on the CPU, not on {device!r}")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"process group backend {backend!r}: nccl or gloo")
    return DataMesh(size=size, device=dev, axis=axis, group=group)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The LM steps' mesh: ('data', 'model') of sizes (D, M).  ``data``,
    ``model`` and ``world`` are the :class:`DataMesh` of the 'data' axis,
    the 'model' axis and the combined ('data', 'model') axis (D·M shards,
    data-major), all emulated or all process groups."""

    data: DataMesh
    model: DataMesh = None
    world: DataMesh = None
    axis_names = ("data", "model")

    def __post_init__(self):
        if self.model is None:  # the 1-D form: a 'model' axis of one shard
            object.__setattr__(self, "model", DataMesh(size=1, device=self.data.device,
                                                       axis="model"))
        if self.world is None:
            object.__setattr__(self, "world", self.data)

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return (self.data.size, self.model.size)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def emulated(self) -> bool:
        return self.data.emulated

    @property
    def coords(self) -> tuple[int, int] | None:
        """(data, model) coordinates of this process's shard in a group,
        None when emulated."""
        if self.emulated:
            return None
        return (self.data.rank, 0 if self.model.emulated else self.model.rank)

    def axis(self, axes) -> DataMesh:
        """The :class:`DataMesh` of ``axes``: 'data', 'model', or the
        combined ('data', 'model') (a tuple of names; a one-name tuple is
        that name)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if names == ("data",):
            return self.data
        if names == ("model",):
            return self.model
        if names == ("data", "model"):
            return self.world
        raise ValueError(f"axes {axes!r}: 'data', 'model' or ('data', 'model')")


def _new_groups(ranks_each: list[list[int]]):
    """Every rank makes every group, in the same order (as ``new_group``
    requires); returns the one holding this rank."""
    me, mine = dist.get_rank(), None
    for ranks in ranks_each:
        g = dist.new_group(ranks)
        if me in ranks:
            mine = g
    return mine


def make_host_mesh(model: int = 1, *, data: int | None = None,
                   device: str | torch.device = "cuda") -> HostMesh:
    """The reference's ('data', 'model') host mesh of ``data`` × ``model``
    shards.  With the default process group initialised it is that group,
    one shard a rank, rank r at (r // model, r % model), and ``data``
    (if given) must be world / model; the model axis is a group of each
    row, the data axis one of each column.  Otherwise it is the emulated
    mesh of ``data`` (default 1) × ``model`` shards on ``device``."""
    if model < 1:
        raise ValueError(f"model={model}: a mesh axis needs at least one device")
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped:
        dm = make_data_mesh(data, device=device)
        if dm.device.type == "cuda" and dm.device.index is None:  # the device tensors report
            dm = dataclasses.replace(dm, device=torch.device("cuda", torch.cuda.current_device()))
        if model == 1:
            return HostMesh(dm)
        mm = DataMesh(size=model, device=dm.device, axis="model")
        return HostMesh(dm, mm, DataMesh(size=dm.size * model, device=dm.device,
                                         axis="data_model"))
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model={model} does not divide a process group of {world} ranks")
    if data is not None and int(data) * model != world:
        raise ValueError(f"data={data} × model={model} for a process group of {world} ranks")
    wm = make_data_mesh(None, axis="data_model", device=device)
    if model == 1:
        return HostMesh(dataclasses.replace(wm, axis="data"))
    D = world // model
    cols = _new_groups([[d * model + m for d in range(D)] for m in range(model)])
    rows = _new_groups([[d * model + m for m in range(model)] for d in range(D)])
    return HostMesh(DataMesh(size=D, device=wm.device, axis="data", group=cols),
                    DataMesh(size=model, device=wm.device, axis="model", group=rows), wm)


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A mesh as shapes and names only (no device): what the layout
    tables (``launch.sharding``) read, ``axis_names`` and ``shape``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh: (16, 16) ('data', 'model'), one
    pod of 256 chips, or (2, 16, 16) ('pod', 'data', 'model')."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
