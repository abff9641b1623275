"""Device-idle ms a ``cp_search`` inside the program's ``index.cp_search``
range and outside every ``cp.*`` one, in the profiled slice."""
from bench.lib import spans


def read(run):
    return spans.idle_ms(run.profile, {"index.cp_search"}, outside="cp.")
