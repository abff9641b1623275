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
reference's host mesh of ('data', 'model') axes on one device: the
model steps run on it whole.  Tensor and expert parallelism over
'model' > 1 come with more than one card (ROADMAP A12d).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["DataMesh", "HostMesh", "axis_size", "dp_axes", "make_data_mesh",
           "make_host_mesh"]


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


def make_data_mesh(shards: int | None = None, axis: str = "data", *, group=None,
                   device: str | torch.device = "cuda") -> DataMesh:
    """The 1-D row mesh of the sharded backends.

    With a ``group``, or with none and the default process group
    initialised, the mesh is that group: one shard per rank, ``shards``
    (if given) equal to its size, NCCL on ``cuda:rank`` or gloo on the
    CPU (``device`` must name that device type).  Otherwise it is the
    emulated mesh of ``shards`` (default 1) shards on ``device``.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return DataMesh(size=1 if shards is None else int(shards),
                        device=resolve_device(device), axis=axis)
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
    """The LM steps' mesh: named axes of given sizes over ``device``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_host_mesh(model: int = 1, *, device: str | torch.device = "cuda") -> HostMesh:
    """A ('data', 'model') mesh of one device (tests / examples): the
    reference's host mesh at one device.  ``model > 1`` raises."""
    if model < 1:
        raise ValueError(f"model={model}: a mesh axis needs at least one device")
    if model > 1:
        raise NotImplementedError(
            f"make_host_mesh(model={model}): tensor and expert parallelism over a "
            "'model' axis come with more than one card (ROADMAP A12d)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the device tensors report
        dev = torch.device("cuda", torch.cuda.current_device())
    return HostMesh(("data", "model"), (1, 1), dev)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
