"""% of the estimate kernel's device time that its least time is
(``bench/cost/estimate.py`` at each profiled call's (B, n, m))."""
from bench.lib import readers


def read(run):
    kind = run.kind
    return readers.roofline(run, "estimate", lambda info: {
        "B": info["B"], "n": kind.n, "m": kind.m})
