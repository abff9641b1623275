"""repro_torch.obs — tracing, rooflines, metrics, and quality auditing
(the port of ``repro.obs``).

Hierarchical wall-clock spans over every query engine (``obs.trace``),
modeled bytes/FLOPs per kernel dispatch placed on the H100's roofline
(``obs.roofline``), Chrome-trace/Perfetto + flat-summary exporters
(``obs.export``), a process-global metrics registry with Prometheus
text exposition (``obs.metrics``), a shadow ground-truth quality
auditor — online recall@k / approximation ratio / Lemma-3 CI coverage
over hash-sampled live queries, scored on the index's device
(``obs.quality``) — and a streaming projection-drift monitor that
raises a recalibrate signal (``obs.drift``).

Quickstart::

    from repro_torch import obs

    with obs.tracing() as tr:
        index.search(Q, k=10)
    obs.save_chrome_trace("query_trace.json", tr)   # open in Perfetto
    print(obs.stage_summary(tr))                    # flat per-stage µs

    auditor = obs.QualityAuditor.for_index(index, sample_fraction=0.05)
    res = index.search(q[None], k=10)
    auditor.maybe_sample(q, res.indices[0], res.distances[0])
    auditor.audit()
    print(auditor.report())                 # recall / ratio / coverage
    print(obs.get_registry().to_prometheus())
"""
from . import drift, export, metrics, quality, roofline, trace
from .drift import DriftMonitor, DriftReport
from .export import (coverage, save_chrome_trace, stage_summary,
                     to_chrome_trace, validate_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .quality import QualityAuditor, QualityReport
from .roofline import DevicePeaks, KernelCost, achieved, device_kind
from .trace import (Span, Trace, Tracer, add_span, block, disable, enable,
                    enabled, get_tracer, span)
from .trace import trace as tracing

__all__ = [
    "tracing", "Span", "Trace", "Tracer", "get_tracer",
    "enabled", "enable", "disable", "span", "add_span", "block",
    "export", "roofline", "trace", "KernelCost",
    "DevicePeaks", "achieved", "device_kind", "to_chrome_trace",
    "save_chrome_trace", "validate_chrome_trace", "stage_summary",
    "coverage", "metrics", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_registry", "quality", "QualityAuditor",
    "QualityReport", "drift", "DriftMonitor", "DriftReport",
]

# the tracer's ring-buffer drop counter, scrapeable alongside the
# quality and durability series (pull-time: reads the live tracer on
# collect)
get_registry().gauge(
    "trace_dropped_spans", "spans dropped by the tracer ring buffer"
).set_fn(lambda: float(get_tracer().dropped))
