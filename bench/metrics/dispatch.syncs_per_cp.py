"""Host waits on the device a ``cp_search`` makes: the program's
``sync.*`` spans over the span slice's calls."""
from bench.lib import spans


def read(run):
    return spans.spans_per_call(run, "sync.")
