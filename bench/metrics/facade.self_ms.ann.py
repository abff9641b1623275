"""Mean ms of an ``index.search`` span less its ``ann.*`` children: the
facade's own work around the pipeline (numpy checks, the upload, the
answer distances, the copies back), from the program's spans."""
from bench.lib import readers


def read(run):
    return readers.span_self_ms(run, "index.search", "ann.")
