"""The PM-LSH core: estimator, hash families, the paper-faithful PM-tree
index (host algorithms, projections on the card), the flat index, the
fused query pipeline, the closest-pair engine and the sharded engines on
the card (counterparts of ``repro.core``)."""
from .ann import PMLSH, AnnResult  # noqa: F401
from .cp import PMLSH_CP, CpResult, calibrate_gamma  # noqa: F401
from .cp_fused import CpFusedResult, cp_fused_search, cp_threshold2  # noqa: F401
from .distributed import DistributedCP, DistributedFlatIndex  # noqa: F401
from .estimator import PMLSHParams, chi2_ppf, select_rmin, solve_parameters  # noqa: F401
from .flat_index import (  # noqa: F401
    FlatIndex,
    ann_query,
    answer_distances,
    build_flat_index,
    candidate_budget,
)
from .fused import fused_ann_query, select_seed  # noqa: F401
from .hashing import BucketFamily, ProjectionFamily  # noqa: F401
from .pmtree import FlatPMTree, build_bulk, build_insert  # noqa: F401
from .sharded import BISECT_ROUNDS, ShardedFlatIndex, pad_rows  # noqa: F401
