"""Mean ms of a ``serve.submit`` span (validation, the SQ8 cache probe,
admission, bucketing) less the ``serve.flush`` a full bucket runs inside
it: the program's own twin of the submit share of ``serve.self_ms``."""
from bench.lib import readers


def read(run):
    return readers.span_self_ms(run, "serve.submit", "serve.flush")
