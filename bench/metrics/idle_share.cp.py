"""% of the profiled slice in which the device ran nothing."""
from bench.lib import readers


def read(run):
    return readers.idle_share(run)
