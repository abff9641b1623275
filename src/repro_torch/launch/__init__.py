"""The port of ``repro.launch``: the 1-D data mesh the sharded index
backends run over and the row layout of their arrays (``mesh``,
``sharding``), the LM's ('data', 'model') host mesh whose data axis is
such a mesh (``make_host_mesh``, ``dp_axes``, ``axis_size``) with its
batch and cache specs (``sharding.batch_pspecs`` / ``cache_pspecs``), the
batched serving driver (``serve``), the fault-tolerant train loop
(``train``) and its checkpoints in the reference's layout
(``checkpoint``).  Production meshes, a 'model' axis past one device,
parameter layouts and the dry run are ROADMAP A12d3 and A12d4.
"""
from .mesh import (  # noqa: F401
    DataMesh,
    HostMesh,
    axis_size,
    dp_axes,
    make_data_mesh,
    make_host_mesh,
)
from .sharding import (  # noqa: F401
    batch_pspecs,
    cache_pspecs,
    index_row_split,
    local_shape,
    shard_rows,
    split_dims,
)
