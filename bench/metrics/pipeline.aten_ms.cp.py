"""Device ms of each ``cp_search`` spent outside the program's CUDA
kernels (the sort, gathers and copies), from the profiled slice."""
from bench.lib import readers


def read(run):
    return readers.aten_ms(run)
