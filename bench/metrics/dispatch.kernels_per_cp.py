"""Device kernels in the profiled slice for each ``cp_search``."""
from bench.lib import readers


def read(run):
    return readers.kernels_per(run, 1)
