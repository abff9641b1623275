"""Device ms of each search spent outside the program's CUDA kernels
(torch's gathers, sorts and copies), from the profiled slice."""
from bench.lib import readers


def read(run):
    return readers.aten_ms(run)
