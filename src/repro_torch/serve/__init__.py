"""repro_torch.serve — the serving front end over the
``repro_torch.index`` facade (the port of ``repro.serve``).

Two layers:

  * ``serve_step`` — the per-call building block :class:`RetrievalStep`
    (one batched facade search + payload gather, with streaming
    ``extend``/``evict``).
  * the request scheduler — :class:`RequestScheduler` turns ragged
    production traffic (variable B, mixed k, bursts, interleaved
    inserts) into the padded shapes of a powers-of-two (B_pad, k_pad)
    bucket palette, served by the fused kernels on the card:
    continuous batching with deadline-aware flushes (``batcher``), an
    LRU hot-query cache keyed on SQ8 codes (``cache``), admission
    control with watermark degrade/shed (``admission``), and a full
    metrics surface — p50/p99, QPS, hit/shed rates, padding overhead,
    shape counters (``metrics``).

Quickstart::

    from repro_torch.serve import RequestScheduler, ServeConfig
    from repro_torch.serve.serve_step import make_retrieval_step

    step, index = make_retrieval_step(keys, values, k=10)  # device="cuda"
    sched = RequestScheduler(step, config=ServeConfig(b_max=32))
    t = sched.submit(q, k=10, deadline_ms=5.0)
    sched.pump()                      # serving-loop tick
    resp = t.result()                 # (1, k) SearchResult + payloads
    sched.snapshot()                  # p50/p99/QPS/hit-rate/shed-rate

``RetrievalStep`` / ``make_retrieval_step`` and the model steps
``make_prefill`` / ``make_decode_step`` load lazily here, as in the
reference.
"""
from .admission import ADMIT, DEGRADE, SHED, AdmissionController  # noqa: F401
from .batcher import (  # noqa: F401
    PAD_DISTANCE,
    BucketPalette,
    StagingBuffers,
    pow2_ceil,
)
from .cache import SQ8QueryCache  # noqa: F401
from .metrics import (  # noqa: F401
    BucketSnapshot,
    MetricsSnapshot,
    ServeMetrics,
)
from .scheduler import (  # noqa: F401
    RejectedQuery,
    RequestScheduler,
    Response,
    ServeConfig,
    Ticket,
)

_LAZY = ("RetrievalStep", "make_retrieval_step", "make_prefill", "make_decode_step")

__all__ = [
    "ADMIT", "DEGRADE", "SHED", "AdmissionController",
    "BucketPalette", "PAD_DISTANCE", "StagingBuffers", "pow2_ceil",
    "SQ8QueryCache",
    "BucketSnapshot", "MetricsSnapshot", "ServeMetrics",
    "RejectedQuery", "RequestScheduler", "Response", "ServeConfig", "Ticket",
    *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        from . import serve_step

        return getattr(serve_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
