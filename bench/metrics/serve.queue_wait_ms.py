"""Mean ms a request waits in its bucket, from its ``submit`` to the start
of its flush's search: the program's ``serve.queue_wait`` spans.  The
batching policy's share of the serving latency."""


def read(run):
    s = run.spans
    waits = [sp.duration_s for sp in s.named("serve.queue_wait")] if s is not None else []
    return 1e3 * sum(waits) / len(waits) if waits else None
