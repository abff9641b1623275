"""The port of ``repro.launch``: the 1-D data mesh the sharded index
backends run over and the row layout of their arrays (``mesh``,
``sharding``), the LM's ('data', 'model') host mesh whose axes are such
meshes (``make_host_mesh``, ``dp_axes``, ``axis_size``) with its batch,
cache and parameter specs (``sharding.batch_pspecs`` / ``cache_pspecs``
/ ``param_pspecs`` and the per-layer view ``layer_layouts``), the
production mesh as shapes and names (``make_production_mesh``), the
batched serving driver (``serve``), the fault-tolerant train loop
(``train``), its checkpoints in the reference's layout
(``checkpoint``), and the dry run (``dryrun``): each (arch × shape) cell's
step traced on the meta device as one rank of the production mesh
(``make_abstract_mesh``), its FLOPs, bytes and collectives and the H100's
roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
        --shape train_4k --mesh single
"""
from .mesh import (  # noqa: F401
    AbstractDataMesh,
    CollectiveTally,
    DataMesh,
    HostMesh,
    ProductionMesh,
    axis_size,
    dp_axes,
    make_abstract_mesh,
    make_data_mesh,
    make_host_mesh,
    make_production_mesh,
)
from .sharding import (  # noqa: F401
    LeafLayout,
    batch_pspecs,
    cache_pspecs,
    index_row_split,
    layer_layouts,
    local_block,
    local_shape,
    param_pspecs,
    shard_rows,
    split_dims,
)
