"""Mean ms of an ``index.cp_search`` span less its ``cp.*`` children."""
from bench.lib import readers


def read(run):
    return readers.span_self_ms(run, "index.cp_search", "cp.")
