"""repro_torch.index — the Index facade of the port (``repro.index``).

    from repro_torch.index import IndexConfig, build_index

    index = build_index(data, IndexConfig(backend="flat"))   # device="cuda"
    res = index.search(queries, k=10)     # (B, k) int32 / float32 numpy
    res.stats.candidates_selected         # unified work accounting

    pairs = index.cp_search(10)           # closest pairs (CpSearchResult)
    pq = build_index(data, IndexConfig(backend="flat-pq"))  # PQ codes + ADC
    pm = build_index(data, IndexConfig(backend="pmtree"))   # the paper's host index
    st = build_index(data, IndexConfig(backend="streaming"))  # pmtree segments
    st.insert(rows); st.delete(ids); st.flush()   # a mutable index

    sh = build_index(data, IndexConfig(backend="sharded-flat",
                                        options={"shards": 4}))  # flat's answers

``device`` defaults to the card and raises where CUDA is absent; pass
``device="cpu"`` for the plain PyTorch versions.  Every backend of the
reference is ported (``available_backends()``).
"""
from .backends import (  # noqa: F401
    BaseIndex,
    FlatBackend,
    FlatPQBackend,
    PMTreeBackend,
    ShardedBackend,
    ShardedFlatBackend,
    ShardedFlatPQBackend,
)
from .config import IndexConfig  # noqa: F401
from .registry import (  # noqa: F401
    KNOWN_CAPABILITIES,
    available_backends,
    backend_capabilities,
    build_index,
    get_backend,
    register_backend,
)
from .types import (  # noqa: F401
    CpSearchResult,
    Index,
    MutableIndex,
    SearchResult,
    WorkStats,
    pack_batch,
)
