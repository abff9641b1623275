"""NLJ — exact blocked nested-loop join (the CP ground truth)."""
from __future__ import annotations

import numpy as np

from ..cp import PMLSH_CP


class NLJ:
    def __init__(self, data: np.ndarray, **_):
        self.data = np.asarray(data, np.float32)

    def cp_query(self, k: int):
        # reuse the blocked implementation from the core (exact_cp)
        helper = PMLSH_CP.__new__(PMLSH_CP)
        helper.data = self.data
        helper.n = self.data.shape[0]
        res = PMLSH_CP.exact_cp(helper, k=k)
        return res.pairs, res.distances, res.pairs_verified
