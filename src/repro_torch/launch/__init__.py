"""The port of ``repro.launch``: the 1-D data mesh the sharded index
backends run over and the row layout of their arrays (``mesh``,
``sharding``), the LM's one-device host mesh (``make_host_mesh``,
``dp_axes``, ``axis_size``), the batched serving driver (``serve``),
the fault-tolerant train loop (``train``) and its checkpoints in the
reference's layout (``checkpoint``).  Production meshes, parameter /
batch / cache layouts over many cards and the dry run are not ported
yet (ROADMAP A12d).
"""
from .mesh import (  # noqa: F401
    DataMesh,
    HostMesh,
    axis_size,
    dp_axes,
    make_data_mesh,
    make_host_mesh,
)
from .sharding import index_row_split, shard_rows  # noqa: F401
