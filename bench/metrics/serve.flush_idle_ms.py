"""Device-idle ms a flush while the program's ``serve.flush`` range is
open, in the profiled slice: the host work of a flush that leaves the
device waiting."""
from bench.lib import spans


def read(run):
    return spans.idle_ms(run.profile, {"serve.flush"}, per="serve.flush")
