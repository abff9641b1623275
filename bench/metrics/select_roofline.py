"""% of the select kernels' device time that their least time is
(``bench/cost/select.py`` at (B, n, T), T = beta n + k by the reference)."""
from bench.lib import readers


def read(run):
    kind = run.kind
    if run.profile is None or not hasattr(kind, "reference"):
        return None
    ref = kind.reference()
    return readers.roofline(run, "select", lambda info: {
        "B": info["B"], "n": kind.n, "T": ref.budget(info["k"])})
