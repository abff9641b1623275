"""% of the traced slice with no ``index.search`` span open: the serving
front end's own host time (submit, probe, bucket, pad, stage, slice,
deliver) and the harness's loop, from the program's spans."""
from bench.lib import readers


def read(run):
    return readers.host_share(run, "index.search")
