"""Process-global metrics registry: counters, gauges, histograms (the
port's copy of ``repro.obs.metrics``).

Observability needs a place for *numbers that outlive one trace*:
request counts, recall gauges, drift scores, latency histograms, the
write-ahead log's fsync latencies.  This module is that backbone — one
process-global :class:`MetricsRegistry` every subsystem reports through
(the tracer's drop counter is exported as a pull-time gauge, the
quality auditor and drift monitor publish their estimates, the
durability manager counts its records and snapshots), exposed in one
place via Prometheus text exposition
(:meth:`MetricsRegistry.to_prometheus`).  Pure Python: the same
operations give the reference's exposition byte for byte.

Design constraints:

  * label sets, bounded cardinality.  Every metric accepts a fixed
    label-name tuple at registration; each distinct label-value tuple
    is one series.  Series count is BOUNDED (``max_series``): past the
    bound, new label sets are dropped and counted in
    ``dropped_series`` instead of stored, so a mis-labeled hot path
    (e.g. a per-request id leaking into a label) cannot grow the
    registry without bound — the same discipline as the tracer's
    bounded span collector.
  * snapshot/delta semantics.  ``snapshot()`` freezes every series
    into plain nested dicts (JSON-serializable as-is);
    ``delta(cur, prev)`` subtracts counter-like values series-wise so
    callers can rate over an interval without the registry itself
    keeping history.
  * exemplars on histograms.  Observations landing at the top of a
    histogram's range may carry an exemplar payload (e.g. a request's
    span breakdown); the histogram retains the ``max_exemplars``
    LARGEST observations per series, so ``slowest(n)`` answers *why*
    the p99 was slow, not just that it was.
  * pull-time gauges.  ``Gauge.set_fn`` registers a callable sampled
    at snapshot/exposition time — how the tracer's live drop counter
    is exported without the tracer importing this module.

Single-threaded by design: metrics need no locks.

Usage::

    from repro_torch.obs import metrics

    reg = metrics.get_registry()
    reqs = reg.counter("serve_requests_total", "requests by status",
                       labels=("status",))
    reqs.inc(status="ok")
    print(reg.to_prometheus())
"""
from __future__ import annotations

import dataclasses
import math
import re

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram bucket upper bounds (seconds-flavored, spanning
#: µs-scale cache hits to second-scale stalls)
DEFAULT_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                   1.0, 5.0)


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series_str(name: str, labels: tuple[tuple[str, str], ...],
                extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared series bookkeeping: labels → one series, bounded count."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 max_series: int = 64):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = str(help)
        self.label_names = tuple(labels)
        self.max_series = int(max_series)
        self.dropped_series = 0  # label sets refused past max_series
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> tuple[str, ...] | None:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[ln]) for ln in self.label_names)
        if key not in self._series and len(self._series) >= self.max_series:
            self.dropped_series += 1
            return None
        return key

    def _labeled(self, key: tuple[str, ...]) -> tuple[tuple[str, str], ...]:
        return tuple(zip(self.label_names, key))

    @property
    def series_count(self) -> int:
        return len(self._series)

    def clear(self) -> None:
        self._series.clear()
        self.dropped_series = 0


class Counter(_Metric):
    """Monotone counter; one float per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        if key is None:
            return
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def get(self, **labels) -> float:
        key = tuple(str(labels[ln]) for ln in self.label_names)
        return float(self._series.get(key, 0.0))

    def collect(self) -> dict[tuple[str, ...], float]:
        return {k: float(v) for k, v in self._series.items()}

    def expose(self, lines: list[str]) -> None:
        for key in sorted(self._series):
            lines.append(f"{_series_str(self.name, self._labeled(key))} "
                         f"{_fmt_value(self._series[key])}")


class Gauge(_Metric):
    """Set-to-current-value metric; supports pull-time callables."""

    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._fns: dict[tuple[str, ...], object] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        if key is None:
            return
        self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        if key is None:
            return
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_fn(self, fn, **labels) -> None:
        """Sample ``fn()`` at collection time (snapshot / exposition)
        instead of storing a value — for live counters owned elsewhere
        (e.g. the tracer's drop count)."""
        key = self._key(labels)
        if key is None:
            return
        self._series.setdefault(key, 0.0)
        self._fns[key] = fn

    def get(self, **labels) -> float:
        key = tuple(str(labels[ln]) for ln in self.label_names)
        fn = self._fns.get(key)
        if fn is not None:
            return float(fn())
        return float(self._series.get(key, 0.0))

    def collect(self) -> dict[tuple[str, ...], float]:
        out = {}
        for k, v in self._series.items():
            fn = self._fns.get(k)
            out[k] = float(fn()) if fn is not None else float(v)
        return out

    def expose(self, lines: list[str]) -> None:
        for key, val in sorted(self.collect().items()):
            lines.append(f"{_series_str(self.name, self._labeled(key))} "
                         f"{_fmt_value(val)}")

    def clear(self) -> None:
        super().clear()
        self._fns.clear()


@dataclasses.dataclass
class _HistSeries:
    counts: list[int]  # per finite bucket, non-cumulative
    overflow: int = 0  # observations past the last finite bucket
    total: int = 0
    sum: float = 0.0
    # (value, payload) exemplars of the LARGEST observations, unsorted
    exemplars: list[tuple[float, dict]] = dataclasses.field(
        default_factory=list)


class Histogram(_Metric):
    """Fixed-bucket histogram with top-value exemplar retention.

    ``observe(v, exemplar={...})`` files v into its bucket and — when
    an exemplar payload is given — retains it if v ranks among the
    ``max_exemplars`` largest observations of its series so far.
    ``slowest(n)`` returns those payloads value-descending: the tail
    attribution a plain histogram cannot give.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 max_series: int = 64, max_exemplars: int = 8):
        super().__init__(name, help, labels, max_series)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError("buckets must be finite and non-empty")
        self.buckets = bs
        self.max_exemplars = int(max_exemplars)

    def _rec(self, labels: dict) -> _HistSeries | None:
        key = self._key(labels)
        if key is None:
            return None
        rec = self._series.get(key)
        if rec is None:
            rec = self._series[key] = _HistSeries([0] * len(self.buckets))
        return rec

    def observe(self, value: float, exemplar: dict | None = None,
                **labels) -> None:
        rec = self._rec(labels)
        if rec is None:
            return
        v = float(value)
        rec.total += 1
        rec.sum += v
        placed = False
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                rec.counts[i] += 1
                placed = True
                break
        if not placed:
            rec.overflow += 1
        if exemplar is not None:
            ex = rec.exemplars
            if len(ex) < self.max_exemplars:
                ex.append((v, dict(exemplar)))
            else:
                jmin = min(range(len(ex)), key=lambda j: ex[j][0])
                if v > ex[jmin][0]:
                    ex[jmin] = (v, dict(exemplar))

    def slowest(self, n: int = 5, **labels) -> list[tuple[float, dict]]:
        """The n largest retained (value, exemplar) pairs, descending.
        With no labels given, pools every series."""
        if labels:
            key = tuple(str(labels[ln]) for ln in self.label_names)
            recs = [self._series[key]] if key in self._series else []
        else:
            recs = list(self._series.values())
        pool = [e for r in recs for e in r.exemplars]
        pool.sort(key=lambda t: -t[0])
        return pool[:n]

    def collect(self) -> dict[tuple[str, ...], dict]:
        out = {}
        for key, rec in self._series.items():
            out[key] = {
                "buckets": {ub: c for ub, c in zip(self.buckets, rec.counts)},
                "count": rec.total, "sum": rec.sum,
            }
        return out

    def expose(self, lines: list[str]) -> None:
        for key in sorted(self._series):
            rec = self._series[key]
            lab = self._labeled(key)
            cum = 0
            for ub, c in zip(self.buckets, rec.counts):
                cum += c
                lines.append(
                    f"{_series_str(self.name + '_bucket', lab, (('le', _fmt_value(ub)),))} "
                    f"{cum}")
            lines.append(
                f"{_series_str(self.name + '_bucket', lab, (('le', '+Inf'),))} "
                f"{rec.total}")
            lines.append(f"{_series_str(self.name + '_sum', lab)} "
                         f"{_fmt_value(rec.sum)}")
            lines.append(f"{_series_str(self.name + '_count', lab)} "
                         f"{rec.total}")


class MetricsRegistry:
    """Name → metric map with get-or-create registration.

    Re-registering an existing name returns the SAME metric object
    when kind and label names agree (so modules can idempotently
    declare what they report through), and raises on a mismatch.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels, **kw):
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls or existing.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}{existing.label_names}")
            return existing
        m = cls(name, help, tuple(labels), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = (), **kw) -> Counter:
        return self._get_or_create(Counter, name, help, labels, **kw)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = (), **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels, **kw)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (), **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, **kw)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- snapshot / delta -------------------------------------------------

    def snapshot(self) -> dict:
        """Freeze every series into plain nested dicts:
        ``{name: {"kind": ..., "series": {"a=1,b=x": value}}}`` —
        JSON-serializable as-is (histogram values are sub-dicts with
        bucket counts / count / sum)."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = {}
            for key, val in m.collect().items():
                skey = ",".join(f"{ln}={v}" for ln, v
                                in zip(m.label_names, key)) or ""
                series[skey] = val
            out[name] = {"kind": m.kind, "series": series,
                         "dropped_series": m.dropped_series}
        return out

    @staticmethod
    def delta(cur: dict, prev: dict) -> dict:
        """Series-wise ``cur − prev`` for counter-like values (counters
        and histogram counts/sums); gauges pass through ``cur``.
        Series absent from ``prev`` difference against zero."""
        out = {}
        for name, block in cur.items():
            pseries = prev.get(name, {}).get("series", {})
            dser = {}
            for skey, val in block["series"].items():
                pv = pseries.get(skey)
                if block["kind"] == "counter":
                    dser[skey] = val - (pv or 0.0)
                elif block["kind"] == "histogram":
                    pv = pv or {"buckets": {}, "count": 0, "sum": 0.0}
                    dser[skey] = {
                        "buckets": {ub: c - pv["buckets"].get(ub, 0)
                                    for ub, c in val["buckets"].items()},
                        "count": val["count"] - pv["count"],
                        "sum": val["sum"] - pv["sum"],
                    }
                else:  # gauge: a delta of a level is rarely meaningful
                    dser[skey] = val
            out[name] = {"kind": block["kind"], "series": dser}
        return out

    # -- exposition -------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            m.expose(lines)
        return "\n".join(lines) + "\n" if lines else ""

    def reset(self) -> None:
        """Drop every registered metric (tests only)."""
        self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
