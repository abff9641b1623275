"""Competitor algorithms from the paper's experimental study (§7.1), the
counterparts of ``repro.core.baselines``.

NN:  Multi-Probe [35], QALSH [27], SRS [47], R-LSH (R-tree variant of
     PM-LSH), LScan (70% linear scan).
CP:  LSB-tree [49], ACP-P [7], MkCP/GMA [19], NLJ (exact nested loop).

All expose a uniform interface so the benchmark harness can sweep them:
NN:  index = X(data, c=..., m=..., seed=...); idx, dist, work = index.query(q, k)
CP:  index = Y(data, ...); pairs, dist, work = index.cp_query(k)

`work` counts original-space distance computations — the cost metric
the paper's analysis uses.  They are host algorithms: the ones whose
hash families the reference draws with ``jax.random`` (Multi-Probe,
LSB-tree, SRS, R-LSH) draw theirs from a ``torch.Generator`` on the
index's device, or take given families (``families=``, ``a=``) so a
parity test can pass in the reference's draws; the rest draw with numpy
as the reference does.
"""
from .lscan import LScan  # noqa: F401
from .multiprobe import MultiProbe  # noqa: F401
from .qalsh import QALSH  # noqa: F401
from .srs import SRS, RLSH  # noqa: F401
from .lsb_tree import LSBTree  # noqa: F401
from .acp_p import ACPP  # noqa: F401
from .mkcp import MkCP  # noqa: F401
from .nlj import NLJ  # noqa: F401
