"""The PM-LSH core on the card: estimator, projection family, flat index,
the fused query pipeline and the closest-pair engine (counterparts of
``repro.core``)."""
from .cp_fused import CpFusedResult, cp_fused_search, cp_threshold2  # noqa: F401
from .estimator import PMLSHParams, chi2_ppf, solve_parameters  # noqa: F401
from .flat_index import (  # noqa: F401
    FlatIndex,
    ann_query,
    answer_distances,
    build_flat_index,
    candidate_budget,
)
from .fused import fused_ann_query, select_seed  # noqa: F401
from .hashing import ProjectionFamily  # noqa: F401
