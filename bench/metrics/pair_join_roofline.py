"""% of the pair join's device time that its least time is
(``bench/cost/pair_join.py``, its pairs those whose key gap lies within
reach of the exact k-th distance, counted by the reference)."""
from bench.lib import readers


def read(run):
    kind = run.kind
    if run.profile is None or not hasattr(kind, "reference_radius"):
        return None
    ref = kind.reference()
    counted = {}

    def pairs(k):
        if k not in counted:
            counted[k] = ref.filter_pairs(kind.reference_radius(k))
        return counted[k]

    return readers.roofline(run, "pair_join", lambda info: {
        "n": kind.n, "d": kind.d, "k": info["k"], "pairs": pairs(info["k"])})
