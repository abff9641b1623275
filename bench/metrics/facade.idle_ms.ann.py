"""Device-idle ms a search while the facade's own code runs: inside the
program's ``index.validate`` or ``index.search`` ranges and outside every
``ann.*`` one (the query checks, the upload, the copies back), in the
profiled slice, where the program's spans are profiler ranges."""
from bench.lib import spans


def read(run):
    return spans.idle_ms(run.profile, {"index.validate", "index.search"}, outside="ann.")
