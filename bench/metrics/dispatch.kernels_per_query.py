"""Device kernels in the profiled slice for each query of a batch."""
from bench.lib import readers


def read(run):
    if run.profile is None or not run.profile.info:
        return None
    return readers.kernels_per(run, int(run.profile.info[0].get("B", 1)))
