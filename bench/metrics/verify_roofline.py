"""% of the verify kernels' device time that their least time is
(``bench/cost/verify.py``, its distinct rows counted from the reference's
candidate sets of each profiled call's queries)."""
from bench.lib import readers


def read(run):
    kind = run.kind
    if run.profile is None or not run.profile.info or not hasattr(kind, "query"):
        return None
    ref = kind.reference()

    def shapes(info):
        T = ref.budget(info["k"])
        cand = ref.candidates(kind.query(info["call"]), T)
        return {"B": info["B"], "T": T, "d": kind.d, "k": info["k"],
                "rows": readers.distinct_rows(cand)}

    return readers.roofline(run, "verify", shapes)
