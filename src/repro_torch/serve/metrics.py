"""ServeMetrics — the scheduler's observability surface (the port of
``repro.serve.metrics``; the same counters, quantiles and ``serve_*``
series).

One mutable accumulator (``ServeMetrics``) records every event the
request path emits — submissions, cache hits/misses, shed and degraded
requests, per-bucket flushes with real vs. padded slot counts,
compile-cache hits/misses, per-request latencies — plus the summed
``WorkStats`` of every index call.  ``snapshot()`` freezes the current
state into an immutable :class:`MetricsSnapshot` with the derived
serving numbers: p50/p99 latency (overall and per bucket shape), QPS,
cache hit rate, shed rate, and padding overhead (padded slots that
carried no real query).

The port has no jit: a "compile" here is the first sighting of a
``(B_pad, k_pad, tier)`` shape, which is what the scheduler reports
through ``on_compile`` — the reference's count of jit programs for the
same traffic.

Accounting invariant: ``submitted == completed + shed + failed +
pending`` — every submitted request is exactly one of answered, shed,
quarantine-failed, or still queued.  Queries refused at ``submit()``
(``rejected``) never enter ``submitted`` at all.  Cache hits complete
without a flush, so they appear in ``completed`` but in no bucket's
slot counts.

Latency memory is BOUNDED: quantiles come from fixed-capacity
:class:`LatencyReservoir`s (Vitter's Algorithm R), not unbounded
lists, so a long-running server's metrics footprint is a constant —
``cap`` samples overall plus ``cap`` per flushed bucket shape — while
p50/p99 stay unbiased estimates over the full request history.
"""
from __future__ import annotations

import dataclasses
import itertools
import random

import numpy as np

from ..index.types import WorkStats
from ..obs import metrics as obs_metrics

__all__ = ["BucketSnapshot", "LatencyReservoir", "MetricsSnapshot",
           "ServeMetrics"]

# distinct default seeds for successive reservoirs: with a SHARED seed
# every reservoir walks the same RNG replacement stream, so the overall
# and per-bucket samples over one request history keep/evict the same
# slots in lockstep — correlated samples, correlated quantile error
_SEED_SEQ = itertools.count(1)


class LatencyReservoir:
    """Fixed-capacity uniform sample of an observation stream
    (Vitter's Algorithm R): the first ``cap`` observations are kept
    verbatim; observation ``i`` > cap replaces a uniformly random slot
    with probability ``cap / i``, so at any point every observation so
    far had equal probability of being in the sample.  Quantiles over
    the sample estimate stream quantiles without ever holding more
    than ``cap`` floats.

    ``seed=None`` (the default) derives a distinct per-instance seed so
    co-resident reservoirs sample independently; pass an explicit seed
    only to make a SINGLE reservoir's trajectory reproducible."""

    __slots__ = ("cap", "count", "_samples", "_rng")

    def __init__(self, cap: int = 4096, seed: int | None = None):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.count = 0  # observations ever seen
        self._samples: list[float] = []
        if seed is None:
            # golden-ratio multiplicative mix of the instance ordinal:
            # deterministic per process, distinct per instance
            seed = (next(_SEED_SEQ) * 0x9E3779B97F4A7C15) & (2**64 - 1)
        self._rng = random.Random(seed)

    def observe(self, value: float) -> None:
        self.count += 1
        if len(self._samples) < self.cap:
            self._samples.append(float(value))
            return
        j = self._rng.randrange(self.count)
        if j < self.cap:
            self._samples[j] = float(value)

    def samples(self) -> list[float]:
        return list(self._samples)

    def __len__(self) -> int:
        return len(self._samples)


def _quantiles_us(samples: list[float] | LatencyReservoir
                  ) -> tuple[float, float]:
    if isinstance(samples, LatencyReservoir):
        samples = samples.samples()
    if not samples:
        return 0.0, 0.0
    s = np.asarray(samples, np.float64) * 1e6
    return float(np.percentile(s, 50)), float(np.percentile(s, 99))


@dataclasses.dataclass(frozen=True)
class BucketSnapshot:
    """Per-(B_pad, k_pad) serving numbers at snapshot time."""

    shape: tuple[int, int]  # (B_pad, k_pad)
    flushes: int
    real_slots: int  # slots that carried a live request
    padded_slots: int  # B_pad summed over flushes
    p50_us: float
    p99_us: float

    @property
    def padding_overhead(self) -> float:
        """Fraction of executed slots that were padding."""
        if self.padded_slots == 0:
            return 0.0
        return 1.0 - self.real_slots / self.padded_slots


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Immutable view of the serving counters + derived rates."""

    submitted: int
    completed: int
    shed: int
    degraded: int
    pending: int
    cache_hits: int
    cache_misses: int
    compile_hits: int
    compile_misses: int
    deadline_flushes: int
    full_flushes: int
    forced_flushes: int
    staging_reuses: int
    queue_depth: int
    wall_s: float
    p50_us: float
    p99_us: float
    buckets: tuple[BucketSnapshot, ...]
    work: WorkStats
    # resilience counters (defaulted: appended after the seed fields)
    failed: int = 0  # quarantine-isolated poison requests
    rejected: int = 0  # refused at submit() (never counted submitted)
    retries: int = 0  # ladder retries after a failed/timed-out search
    hedges: int = 0  # flushes hedged to the degraded tier
    quarantine_flushes: int = 0  # bisection sub-flushes

    @property
    def qps(self) -> float:
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cache_hit_rate(self) -> float:
        looked = self.cache_hits + self.cache_misses
        return self.cache_hits / looked if looked else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    @property
    def degraded_rate(self) -> float:
        return self.degraded / self.submitted if self.submitted else 0.0

    @property
    def padding_overhead(self) -> float:
        """Executed-but-empty slot fraction, over every flushed bucket."""
        real = sum(b.real_slots for b in self.buckets)
        padded = sum(b.padded_slots for b in self.buckets)
        return 1.0 - real / padded if padded else 0.0

    @property
    def compile_rate(self) -> float:
        """Compiles per flush — ≈0 once the palette is warm."""
        flushes = sum(b.flushes for b in self.buckets)
        return self.compile_misses / flushes if flushes else 0.0


class ServeMetrics:
    """Mutable serving-counter accumulator (one per scheduler).

    ``latency_cap`` bounds quantile memory: the overall stream and
    each bucket shape keep at most that many latency samples (see
    :class:`LatencyReservoir`).

    Every event is ALSO mirrored into the process-global metrics
    registry (``repro_torch.obs.metrics``): ``serve_requests_total{event}``,
    ``serve_cache_total{outcome}``, ``serve_flushes_total{reason}``,
    ``serve_compile_total{outcome}``, and the
    ``serve_latency_seconds{shape}`` histogram — so one Prometheus
    endpoint exposes the serving stack next to the quality/drift
    gauges.  Requests landing in the histogram's top range retain
    their stage breakdown (queue-wait / search / deliver) as
    exemplars; :meth:`slowest` returns them value-descending, the
    answer to *why* a p99 request was slow."""

    def __init__(self, clock, latency_cap: int = 4096, registry=None):
        self._clock = clock
        self._latency_cap = int(latency_cap)
        self._t0: float | None = None  # first submit
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.degraded = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.compile_hits = 0
        self.compile_misses = 0
        self.deadline_flushes = 0
        self.full_flushes = 0
        self.forced_flushes = 0
        self.quarantine_flushes = 0
        self.staging_reuses = 0
        self.failed = 0
        self.rejected = 0
        self.retries = 0
        self.hedges = 0
        self.work = WorkStats()
        # per-(B_pad, k_pad): [flushes, real_slots, padded_slots,
        #                      LatencyReservoir]
        self._buckets: dict[tuple[int, int], list] = {}
        self._latencies = LatencyReservoir(self._latency_cap)
        reg = registry if registry is not None else obs_metrics.get_registry()
        self._c_requests = reg.counter(
            "serve_requests_total", "requests by lifecycle event",
            labels=("event",))
        self._c_cache = reg.counter(
            "serve_cache_total", "query-cache probes", labels=("outcome",))
        self._c_flushes = reg.counter(
            "serve_flushes_total", "bucket flushes by trigger",
            labels=("reason",))
        self._c_compile = reg.counter(
            "serve_compile_total", "step-fn compile-cache probes",
            labels=("outcome",))
        self._h_latency = reg.histogram(
            "serve_latency_seconds", "request latency (submit to deliver)",
            labels=("shape",))
        self._c_selected = reg.counter(
            "serve_candidates_selected_total",
            "select-stage survivors (realized T) summed over flushes")
        self._c_retries = reg.counter(
            "serve_retries_total",
            "ladder retries after a failed or timed-out search")
        self._c_hedges = reg.counter(
            "serve_hedges_total", "flushes hedged to the degraded tier")
        self._c_breaker = reg.counter(
            "serve_breaker_transitions_total",
            "degraded-tier circuit-breaker transitions", labels=("to",))
        self._g_breaker = reg.gauge(
            "serve_breaker_state",
            "breaker state (0 closed, 1 open, 2 half_open)",
            labels=("tier",))

    # -- event recorders -------------------------------------------------

    def on_submit(self, n: int = 1) -> None:
        if self._t0 is None:
            self._t0 = self._clock()
        self.submitted += n
        self._c_requests.inc(n, event="submitted")

    def on_shed(self) -> None:
        self.shed += 1
        self._c_requests.inc(event="shed")

    def on_reject(self) -> None:
        """Query refused at submit() — never entered ``submitted``."""
        self.rejected += 1
        self._c_requests.inc(event="rejected")

    def on_failed(self) -> None:
        """Quarantine isolated a poison request and failed it solo."""
        self.failed += 1
        self._c_requests.inc(event="failed")

    def on_retry(self) -> None:
        self.retries += 1
        self._c_retries.inc()

    def on_hedge(self) -> None:
        self.hedges += 1
        self._c_hedges.inc()

    def on_cache_error(self) -> None:
        """Cache probe raised (injected or real): served the full path."""
        self.cache_misses += 1
        self._c_cache.inc(outcome="error")

    def on_breaker_transition(self, old: str, new: str) -> None:
        self._c_breaker.inc(to=new)

    def bind_breaker(self, state_fn, tier: str = "degraded") -> None:
        """Export a breaker's live state as a pull-time gauge."""
        self._g_breaker.set_fn(state_fn, tier=tier)

    def on_cache_hit(self, latency_s: float) -> None:
        self.cache_hits += 1
        self.completed += 1
        self._latencies.observe(latency_s)
        self._c_cache.inc(outcome="hit")
        self._c_requests.inc(event="completed")
        self._h_latency.observe(latency_s, shape="cache")

    def on_cache_miss(self) -> None:
        self.cache_misses += 1
        self._c_cache.inc(outcome="miss")

    def _bucket_rec(self, shape: tuple[int, int]) -> list:
        rec = self._buckets.get(shape)
        if rec is None:
            rec = self._buckets[shape] = [
                0, 0, 0, LatencyReservoir(self._latency_cap)]
        return rec

    def on_flush(self, shape: tuple[int, int], real: int, *,
                 reason: str) -> None:
        rec = self._bucket_rec(shape)
        rec[0] += 1
        rec[1] += real
        rec[2] += shape[0]
        counter = {"deadline": "deadline_flushes", "full": "full_flushes",
                   "forced": "forced_flushes",
                   "quarantine": "quarantine_flushes"}[reason]
        setattr(self, counter, getattr(self, counter) + 1)
        self._c_flushes.inc(reason=reason)

    def on_complete(self, shape: tuple[int, int], latency_s: float, *,
                    degraded: bool = False,
                    breakdown: dict | None = None) -> None:
        """``breakdown`` (optional) is the request's stage attribution
        — e.g. ``{"queue_wait_ms": ..., "search_ms": ...}`` — kept as a
        histogram exemplar when this latency ranks among the largest."""
        self.completed += 1
        if degraded:
            self.degraded += 1
        self._latencies.observe(latency_s)
        self._bucket_rec(shape)[3].observe(latency_s)
        self._c_requests.inc(event="completed")
        if degraded:
            self._c_requests.inc(event="degraded")
        self._h_latency.observe(latency_s, exemplar=breakdown,
                                shape=f"{shape[0]}x{shape[1]}")

    def on_compile(self, hit: bool) -> None:
        """A flush at a shape seen before (``hit``) or a first sighting
        — the reference's jit-cache probe."""
        if hit:
            self.compile_hits += 1
        else:
            self.compile_misses += 1
        self._c_compile.inc(outcome="hit" if hit else "miss")

    def add_work(self, stats: WorkStats) -> None:
        self.work += stats
        if stats.candidates_selected:
            self._c_selected.inc(stats.candidates_selected)

    def slowest(self, n: int = 5) -> list[tuple[float, dict]]:
        """The n slowest completed requests that retained a stage
        breakdown, as (latency_s, breakdown) descending — pooled over
        every bucket shape."""
        return self._h_latency.slowest(n)

    # -- snapshot --------------------------------------------------------

    def snapshot(self, queue_depth: int = 0) -> MetricsSnapshot:
        wall = 0.0 if self._t0 is None else max(self._clock() - self._t0, 0.0)
        buckets = []
        for shape in sorted(self._buckets):
            flushes, real, padded, lats = self._buckets[shape]
            p50, p99 = _quantiles_us(lats)
            buckets.append(BucketSnapshot(shape, flushes, real, padded,
                                          p50, p99))
        p50, p99 = _quantiles_us(self._latencies)
        return MetricsSnapshot(
            submitted=self.submitted, completed=self.completed,
            shed=self.shed, degraded=self.degraded,
            pending=(self.submitted - self.completed - self.shed
                     - self.failed),
            cache_hits=self.cache_hits, cache_misses=self.cache_misses,
            compile_hits=self.compile_hits,
            compile_misses=self.compile_misses,
            deadline_flushes=self.deadline_flushes,
            full_flushes=self.full_flushes,
            forced_flushes=self.forced_flushes,
            staging_reuses=self.staging_reuses,
            queue_depth=queue_depth, wall_s=wall, p50_us=p50, p99_us=p99,
            buckets=tuple(buckets), work=self.work,
            failed=self.failed, rejected=self.rejected,
            retries=self.retries, hedges=self.hedges,
            quarantine_flushes=self.quarantine_flushes,
        )
