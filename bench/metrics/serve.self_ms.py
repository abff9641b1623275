"""Host ms a request spends in the scheduler's own calls (every ``submit``,
every ``pump`` that flushed: cache probe, admission, bucketing, padding,
staging, slicing, delivery), less the ``index.search`` spans inside them:
the serving front end's work, by the harness's clock and the program's
spans."""
from bench.lib import readers


def read(run):
    return readers.entry_self_ms(run, "index.search")
