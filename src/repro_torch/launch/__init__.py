"""The index's side of ``repro.launch``: the 1-D data mesh the sharded
backends run over (``mesh``) and the row layout of their arrays
(``sharding``).  The LM side of the reference's ``launch/`` (production
and host meshes, parameter, batch and cache layouts) is not ported yet.
"""
from .mesh import DataMesh, make_data_mesh  # noqa: F401
from .sharding import index_row_split, shard_rows  # noqa: F401
