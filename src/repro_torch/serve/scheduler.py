"""RequestScheduler — the serving front end over a RetrievalStep (the
port of ``repro.serve.scheduler``).

This is the layer that turns ragged production traffic into the
padded shapes of a fixed palette, which the fused pipeline's kernels on
the card serve in one batched call each.  One scheduler owns one
primary :class:`RetrievalStep` (and optionally a cheaper degraded-tier
step) and runs the request path:

    submit(q, k, deadline_ms)
      → SQ8 hot-query cache probe       (hit: answer immediately)
      → admission decision on queue depth (admit / degrade / shed)
      → bucket by (k_pad, tier)          (powers-of-two palette)
    pump() / full bucket
      → flush: pad to (B_pad, k_pad), stage through double buffers,
        one facade search, slice per-request responses, fill cache
    ticket.result()
      → force-flush the caller's bucket if still pending

Continuous batching: a bucket flushes the moment it is full, OR when
its oldest request's deadline slack runs out — deadline minus the
service estimate, a per-slot EWMA of observed flush time scaled by the
B_pad the bucket would flush at right now (so a lone trickle request
is not costed like the 64-wide burst that last trained the EWMA) — so
bursts ride at full width and trickles still meet their deadlines.
Every flush shape comes from the fixed palette; the compile counters in
``metrics`` count the first sighting of each (B_pad, k_pad, tier), the
reference's one jit compile per shape.

Degradation (queue past the watermark): requests route to the
``degraded_step`` — typically the same keys behind a quant/ADC index
(``options={"quant": "sq8", "rerank": ...}``), which answers from
1-byte codes at a fraction of the verify cost — or, when no degraded
step is configured, are served at a clamped k (a lowered T = βn + k
candidate budget).  Degraded responses are marked ``degraded=True``
and never populate the cache.  Past ``max_queue`` requests are shed:
the ticket resolves with status "shed" and ``backpressure`` is the
upstream slow-down signal.

The scheduler is single-threaded and cooperative: callers interleave
``submit`` with ``pump`` (and streaming mutations via the
cache-invalidating ``extend``/``evict`` wrappers).  Clock injection
(``clock=``) makes deadline behavior deterministic under test.  The
facade answers numpy results after its own synchronization with the
card, so a flush's wall time includes the card's work.
"""
from __future__ import annotations

import dataclasses
import random
import time
import weakref
from typing import Callable

import numpy as np

from ..index.types import SearchResult
from ..obs import trace as otrace
from ..resilience import chaos
from ..resilience.breaker import CircuitBreaker
from ..resilience.chaos import ChaosError
from .admission import DEGRADE, SHED, AdmissionController
from .batcher import (PAD_DISTANCE, Bucket, BucketPalette, PendingRequest,
                      StagingBuffers)
from .cache import SQ8QueryCache
from .metrics import MetricsSnapshot, ServeMetrics

__all__ = ["ServeConfig", "Response", "Ticket", "RequestScheduler",
           "RejectedQuery"]


class RejectedQuery(ValueError):
    """A query refused at ``submit()`` before it could poison a padded
    batch: non-finite values, wrong shape, or an unconvertible dtype.
    ``reason`` is machine-readable ("nonfinite" | "shape" | "dtype")."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        self.detail = detail
        super().__init__(f"query rejected ({reason}): {detail}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs (palette, deadlines, queue, cache, degrade)."""

    b_max: int = 64  # widest padded batch (power of two)
    k_max: int = 128  # largest padded k (power of two)
    default_deadline_ms: float = 20.0  # slack budget for un-deadlined submits
    max_queue: int = 256  # hard admission limit (SHED past this)
    watermark: float = 0.75  # DEGRADE band starts at watermark·max_queue
    shed_policy: str = "degrade"  # "degrade" | "shed"
    cache: bool = True  # SQ8 hot-query cache on the submit path
    cache_capacity: int = 1024
    degrade_k: int | None = None  # k clamp when no degraded_step (default k//2)
    service_ewma_alpha: float = 0.25  # service-time estimate smoothing
    # -- resilience ladder (DESIGN.md §14) -------------------------------
    retry_backoff_ms: float = 1.0  # base for the jittered pre-retry backoff
    hedge: bool = True  # failed retry may hedge to the degraded tier
    breaker_window: int = 16  # sliding outcome window on degraded_step
    breaker_threshold: float = 0.5  # failure rate that trips OPEN
    breaker_min_calls: int = 4  # outcomes required before tripping
    breaker_reset_s: float = 5.0  # OPEN dwell before a HALF_OPEN probe


@dataclasses.dataclass
class Response:
    """The terminal state of one submitted request."""

    id: int
    status: str  # "ok" | "shed" | "failed" | "rejected"
    result: SearchResult | None = None  # (1, k_req), facade contract
    payloads: np.ndarray | None = None  # values gathered for valid slots
    valid: np.ndarray | None = None  # (1, k_req) bool
    distances: np.ndarray | None = None  # (1, k_req); PAD_DISTANCE when invalid
    cached: bool = False
    degraded: bool = False
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class Ticket:
    """Handle to one submitted request; ``result()`` resolves it.

    Responses are delivered INTO the ticket when its bucket flushes
    (the scheduler holds only a weak reference): a caller that drops
    its ticket drops the response with it, so a pump()-driven server
    never accumulates undelivered payloads."""

    __slots__ = ("_scheduler", "id", "_response", "__weakref__")

    def __init__(self, scheduler: "RequestScheduler", rid: int,
                 response: Response | None = None):
        self._scheduler = scheduler
        self.id = rid
        self._response = response

    @property
    def done(self) -> bool:
        return self._response is not None

    def result(self) -> Response:
        """The response — force-flushing this request's bucket if it is
        still queued (the continuous-batching equivalent of a blocking
        wait)."""
        if self._response is None:
            self._scheduler._resolve(self.id)
        if self._response is None:
            raise KeyError(f"unknown request id {self.id}")
        return self._response


class RequestScheduler:
    """Continuous batching + SQ8 cache + admission over a RetrievalStep."""

    def __init__(self, step, *, config: ServeConfig | None = None,
                 degraded_step=None,
                 clock: Callable[[], float] = time.perf_counter,
                 auditor=None, audit_budget: int = 4):
        self.step = step
        self.config = config or ServeConfig()
        self.degraded_step = degraded_step
        self.clock = clock
        # optional shadow quality auditor (obs.quality.QualityAuditor):
        # each delivered answer is offered for hash-sampling, and pump()
        # scores up to ``audit_budget`` queued samples per call — the
        # brute-force ground truth runs in idle ticks, never in a flush
        self.auditor = auditor
        self.audit_budget = int(audit_budget)
        self.palette = BucketPalette(self.config.b_max, self.config.k_max)
        self.metrics = ServeMetrics(clock)
        self.admission = AdmissionController(
            max_queue=self.config.max_queue,
            watermark=self.config.watermark,
            policy=self.config.shed_policy)
        self.cache: SQ8QueryCache | None = None
        if self.config.cache:
            self.cache = SQ8QueryCache(self.config.cache_capacity)
            self._train_cache_codec(step.index)
        self._buckets: dict[tuple[int, str], Bucket] = {}
        self._staging: dict[tuple[int, str], StagingBuffers] = {}
        # per-SLOT service-time EWMA (flush wall time / B_pad), keyed by
        # (k_pad, tier); scaled back up by the projected flush width in
        # pump(), so the estimate transfers across batch widths
        self._service_ewma: dict[tuple[int, str], float] = {}
        self._seen_shapes: set[tuple[int, int, str]] = set()
        self._pending: dict[int, tuple[int, str]] = {}  # id → bucket key
        # live tickets awaiting flush, weakly referenced: responses are
        # delivered into the ticket, and a dropped ticket drops its
        # response instead of leaking it in a scheduler-side table
        self._tickets: dict[int, weakref.ref[Ticket]] = {}
        self._next_id = 0
        # resilience ladder state: jittered-backoff RNG (deterministic),
        # injectable sleep, and the circuit breaker guarding the
        # degraded tier (OPEN routes degraded buckets back to primary
        # and suppresses hedging until the reset probe succeeds)
        self._jitter_rng = random.Random(0x5EED)
        self._sleep: Callable[[float], None] = time.sleep
        self.breaker = CircuitBreaker(
            window=self.config.breaker_window,
            failure_threshold=self.config.breaker_threshold,
            min_calls=self.config.breaker_min_calls,
            reset_timeout_s=self.config.breaker_reset_s,
            clock=clock,
            on_transition=self.metrics.on_breaker_transition)
        self.metrics.bind_breaker(self.breaker.state_code)

    def _train_cache_codec(self, index) -> None:
        """Give the cache an SQ8 key codec trained on real datastore
        rows.  NEVER trained on queries: a single-query training set
        collapses the grid (per-dim scale clamps to 1e-12) and
        arbitrarily distant queries collide, serving each other's
        results.  When no usable rows or codec exist the cache keys on
        exact query bytes — conservative, never wrong."""
        if self.cache.ensure_codec(getattr(index, "data", None)):
            return
        # codes-only datastore (store_raw=False empties index.data):
        # reuse the index's OWN SQ8 codec, trained on the full rows
        # before they were dropped.  A non-SQ8 codec (PQ) falls through.
        codec = getattr(index, "codec", None)
        if all(hasattr(codec, a) for a in ("scale", "offset", "V")):
            self.cache.adopt(codec)
            return
        # streaming datastores park their rows in an append-only store
        # (index.data stays an empty view): train on the live rows
        live_ids = getattr(index, "live_ids", None)
        get_vectors = getattr(index, "get_vectors", None)
        if callable(live_ids) and callable(get_vectors):
            live = live_ids()
            if len(live):
                self.cache.ensure_codec(get_vectors(live))

    # -- submission ------------------------------------------------------

    def submit(self, query, k: int | None = None,
               deadline_ms: float | None = None) -> Ticket:
        """Enqueue one query; returns a :class:`Ticket` immediately.

        Cache hits and shed requests resolve on the spot; everything
        else waits in a bucket until a full/deadline/forced flush.
        Malformed queries (NaN/Inf, wrong shape, unconvertible dtype)
        raise :class:`RejectedQuery` BEFORE entering any batch — one
        poison row must not spoil B_pad-1 neighbors."""
        now = self.clock()
        q = self._validate_query(query)
        k = int(k if k is not None else self.step.k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.metrics.on_submit()
        rid = self._next_id
        self._next_id += 1

        cache_key = None
        hit = None
        if self.cache is not None:
            # key() degrades to exact-bytes keying when no codec could
            # be trained/adopted — never train on the queries themselves
            # (a single-query grid collapses and distant queries collide)
            try:
                chaos.hit("serve.cache")
                cache_key = self.cache.key(q, k)
                hit = self.cache.get(cache_key,
                                     version=getattr(self.step, "version", 0))
            except ChaosError:
                # a failing cache is never fatal: serve the full path
                cache_key, hit = None, None
                self.metrics.on_cache_error()
            if hit is not None:
                resp = self._respond(rid, hit, self.step, cached=True,
                                     latency_s=self.clock() - now)
                self.metrics.on_cache_hit(resp.latency_s)
                return Ticket(self, rid, resp)
            if cache_key is not None:  # real probe, not an injected error
                self.metrics.on_cache_miss()

        action = self.admission.decide(len(self._pending))
        if action == SHED:
            self.metrics.on_shed()
            resp = Response(rid, "shed", latency_s=self.clock() - now)
            return Ticket(self, rid, resp)

        tier, k_serve, degraded = "primary", k, False
        if action == DEGRADE:
            degraded = True
            if self.degraded_step is not None:
                tier = "degraded"
            else:  # no cheaper tier wired: lower the T = βn + k budget
                k_serve = max(1, min(k, self.config.degrade_k
                                     or max(1, k // 2)))

        deadline = now + (deadline_ms if deadline_ms is not None
                          else self.config.default_deadline_ms) / 1e3
        k_pad = self.palette.k_pad(k_serve)
        bkey = (k_pad, tier)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            bucket = self._buckets[bkey] = Bucket(k_pad, tier)
        bucket.add(PendingRequest(
            rid, q, k_serve, k, deadline, now,
            cache_key=None if degraded else cache_key, degraded=degraded))
        self._pending[rid] = bkey
        # the ticket must exist (and be registered) before a full-bucket
        # flush runs, or its response would be delivered to nobody
        ticket = Ticket(self, rid)
        self._tickets[rid] = weakref.ref(ticket)
        if len(bucket) >= self.config.b_max:
            self._flush(bkey, reason="full")
        return ticket

    def _validate_query(self, query) -> np.ndarray:
        """Normalize one query to a finite float32 (d,) vector or raise
        :class:`RejectedQuery` — the serve-side guarantee that no
        NaN/Inf/misshapen row ever enters a padded batch."""
        try:
            q = np.asarray(query, np.float32).reshape(-1)
        except (TypeError, ValueError) as e:
            self.metrics.on_reject()
            raise RejectedQuery("dtype", str(e)) from e
        if q.size != self.step.index.d:
            self.metrics.on_reject()
            raise RejectedQuery(
                "shape", f"query has d={q.size}, index d={self.step.index.d}")
        if not np.isfinite(q).all():
            self.metrics.on_reject()
            raise RejectedQuery(
                "nonfinite",
                f"{int((~np.isfinite(q)).sum())} non-finite values")
        return q

    def submit_batch(self, queries, k: int | None = None,
                     deadline_ms: float | None = None) -> list[Ticket]:
        """Per-row ``submit``; a row that fails validation yields an
        already-resolved ticket with status "rejected" instead of
        raising, so one poison row cannot veto its batchmates."""
        Q = np.atleast_2d(np.asarray(queries))
        out = []
        for q in Q:
            try:
                out.append(self.submit(q, k, deadline_ms))
            except RejectedQuery:
                rid = self._next_id
                self._next_id += 1
                out.append(Ticket(self, rid, Response(rid, "rejected")))
        return out

    def search(self, queries, k: int | None = None) -> SearchResult:
        """Synchronous convenience: submit a batch, resolve every
        ticket, reassemble the facade-shaped (B, k) SearchResult.
        Shed/rejected/failed rows come back as all-padding (-1 / +inf)."""
        k = int(k if k is not None else self.step.k)
        tickets = self.submit_batch(queries, k)
        indices = np.full((len(tickets), k), -1, np.int32)
        distances = np.full((len(tickets), k), np.inf, np.float32)
        for b, t in enumerate(tickets):
            resp = t.result()
            if resp.ok:
                indices[b] = resp.result.indices[0]
                distances[b] = resp.result.distances[0]
        return SearchResult(indices, distances)

    # -- pumping / flushing ----------------------------------------------

    def pump(self, now: float | None = None) -> int:
        """Flush every bucket whose deadline slack has expired; returns
        the number of requests completed.  Call this from the serving
        loop between submissions (continuous batching's clock tick)."""
        now = self.clock() if now is None else now
        completed = 0
        for bkey in list(self._buckets):
            bucket = self._buckets[bkey]
            # per-slot EWMA × the width THIS bucket would flush at now:
            # a lone request is not costed like the wide burst that
            # last trained the estimate (and vice versa)
            est = (self._service_ewma.get(bkey, 0.0)
                   * self.palette.b_pad(len(bucket)))
            if bucket.due(now, est):
                completed += self._flush(bkey, reason="deadline")
        if self.auditor is not None and self.audit_budget > 0:
            self.auditor.audit(max_items=self.audit_budget)
        return completed

    def drain(self) -> int:
        """Flush everything now (shutdown / end-of-trace)."""
        completed = 0
        for bkey in list(self._buckets):
            completed += self._flush(bkey, reason="forced")
        return completed

    def _flush(self, bkey: tuple[int, str], reason: str) -> int:
        bucket = self._buckets[bkey]
        # injected lost flush (chaos "serve.flush"): the scheduler tick
        # is dropped BEFORE the bucket drains, so requests stay queued
        # and a later pump serves them — delayed, never lost.  Forced
        # flushes (result()/drain) are a caller blocking on the answer
        # and are exempt.
        if reason != "forced" and chaos.dropped("serve.flush"):
            return 0
        reqs = bucket.take_all()
        if not reqs:
            return 0
        # a dropped flush leaves the bucket over-full; serve it in
        # b_max chunks so staging never overflows a palette shape
        done = 0
        for i in range(0, len(reqs), self.config.b_max):
            done += self._execute(reqs[i: i + self.config.b_max], bkey,
                                  reason, depth=0)
        return done

    # -- the deadline-enforcement ladder ---------------------------------

    def _search_tier(self, tier: str, Q: np.ndarray, k_pad: int,
                     budget_s: float) -> SearchResult:
        """One attempt against one tier.  Degraded-tier outcomes feed
        the circuit breaker; chaos latency faults model a call
        abandoned at its budget (ChaosLatencyExceeded ≙ timeout)."""
        if tier == "degraded":
            try:
                chaos.hit("serve.degraded", budget_s)
                res = self.degraded_step.index.search(Q, k=k_pad)
            except Exception:
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            return res
        chaos.hit("serve.search", budget_s)
        return self.step.index.search(Q, k=k_pad)

    def _guarded_search(self, tier: str, Q: np.ndarray, k_pad: int,
                        budget_s: float, *, ladder: bool
                        ) -> tuple[SearchResult, str]:
        """The retry/hedge ladder (DESIGN.md §14): attempt → one retry
        with jittered backoff → hedge to the degraded tier (breaker
        permitting).  Returns (result, tier that answered).  With
        ``ladder=False`` (quarantine sub-batches) it is a single
        attempt."""
        try:
            return self._search_tier(tier, Q, k_pad, budget_s), tier
        except Exception:
            if not ladder:
                raise
            backoff = (self.config.retry_backoff_ms / 1e3
                       * (0.5 + self._jitter_rng.random()))
            self._sleep(backoff)
            self.metrics.on_retry()
            try:
                return self._search_tier(tier, Q, k_pad, budget_s), tier
            except Exception:
                if (tier == "primary" and self.config.hedge
                        and self.degraded_step is not None
                        and self.breaker.allow()):
                    self.metrics.on_hedge()
                    return (self._search_tier("degraded", Q, k_pad,
                                              budget_s), "degraded")
                raise

    def _fail(self, r: PendingRequest, latency_s: float) -> None:
        """Terminal failure of ONE isolated request: the poison is
        failed solo, its batchmates already completed."""
        self.metrics.on_failed()
        self._pending.pop(r.id, None)
        tref = self._tickets.pop(r.id, None)
        ticket = tref() if tref is not None else None
        if ticket is not None:
            ticket._response = Response(r.id, "failed", latency_s=latency_s)

    def _execute(self, reqs: list[PendingRequest], bkey: tuple[int, str],
                 reason: str, depth: int) -> int:
        k_pad, tier = bkey
        # an OPEN breaker routes degraded-bucket flushes back to the
        # primary tier rather than hammering a failing dependency
        serve_tier = tier
        if tier == "degraded" and not self.breaker.allow():
            serve_tier = "primary"
        step = (self.degraded_step if serve_tier == "degraded"
                else self.step)
        b_pad = self.palette.b_pad(len(reqs))
        shape = (b_pad, k_pad)
        with otrace.span("serve.flush", reason=reason, tier=serve_tier,
                         b_pad=b_pad, k_pad=k_pad, real=len(reqs)) as fsp:
            self.metrics.on_flush(shape, real=len(reqs), reason=reason)
            self.metrics.on_compile(
                hit=(b_pad, k_pad, serve_tier) in self._seen_shapes)
            self._seen_shapes.add((b_pad, k_pad, serve_tier))

            skey = (b_pad, serve_tier)
            staging = self._staging.get(skey)
            if staging is None:
                staging = self._staging[skey] = StagingBuffers(
                    b_pad, self.step.index.d)
            with otrace.span("serve.stage"):
                Q = staging.stage([r.query for r in reqs])
            if staging.reuses > 0:
                self.metrics.staging_reuses += 1

            t0 = self.clock()
            # the ladder's abandon budget: slack to the most patient
            # deadline in the batch, floored so a just-expired batch
            # still gets a real attempt
            budget = max(max(r.deadline for r in reqs) - t0, 1e-3)
            try:
                with otrace.span("serve.search"):
                    res, answered = self._guarded_search(
                        serve_tier, Q, k_pad, budget, ladder=depth == 0)
            except Exception:
                # ladder exhausted.  A single request is the isolated
                # poison: fail it solo.  A batch is bisected — each
                # half retried as its own (ladder-less) quarantine
                # flush, so one poison request costs O(log B) extra
                # flushes while its batchmates still complete.
                if len(reqs) == 1:
                    self._fail(reqs[0], self.clock() - reqs[0].submit_t)
                    return 1
                mid = len(reqs) // 2
                done = self._execute(reqs[:mid], bkey, "quarantine",
                                     depth + 1)
                done += self._execute(reqs[mid:], bkey, "quarantine",
                                      depth + 1)
                return done
            hedged = answered != serve_tier
            step = (self.degraded_step if answered == "degraded"
                    else self.step)
            # normalize to per-slot time so the estimate transfers
            # across batch widths (pump() scales it back up by the
            # projected B_pad)
            dt = (self.clock() - t0) / b_pad
            alpha = self.config.service_ewma_alpha
            prev = self._service_ewma.get(bkey)
            self._service_ewma[bkey] = (dt if prev is None
                                        else alpha * dt + (1 - alpha) * prev)
            self.metrics.add_work(res.stats)
            if fsp is not None:
                # queue-wait is scheduler-clock time between submit and
                # service start; per-request spans are only emitted
                # under the real perf_counter clock, where the
                # timestamps share the span timeline's epoch
                waits = [max(t0 - r.submit_t, 0.0) for r in reqs]
                fsp.attrs["queue_wait_mean_ms"] = round(
                    sum(waits) / len(waits) * 1e3, 4)
                fsp.attrs["queue_wait_max_ms"] = round(max(waits) * 1e3, 4)
                fsp.attrs["work"] = res.stats.as_dict()
                if self.clock is time.perf_counter:
                    for r in reqs:
                        otrace.add_span("serve.queue_wait", r.submit_t,
                                        t0, rid=r.id)

            version = getattr(step, "version", 0)
            done_t = self.clock()
            with otrace.span("serve.deliver"):
                for i, r in enumerate(reqs):
                    sub = SearchResult(res.indices[i: i + 1, : r.k].copy(),
                                       res.distances[i: i + 1, : r.k].copy())
                    if r.k_req > r.k:  # degraded k clamp: pad back to
                        # the requested k
                        pad_i = np.full((1, r.k_req), -1, np.int32)
                        pad_d = np.full((1, r.k_req), np.inf, np.float32)
                        pad_i[:, : r.k] = sub.indices
                        pad_d[:, : r.k] = sub.distances
                        sub = SearchResult(pad_i, pad_d)
                    latency = done_t - r.submit_t
                    resp = self._respond(r.id, sub, step,
                                         degraded=r.degraded or hedged,
                                         latency_s=latency)
                    self._pending.pop(r.id, None)
                    # stage attribution from the scheduler's own clock
                    # stamps (works under fake clocks and without a
                    # tracer): retained as a latency-histogram exemplar
                    # when this request ranks among the slowest, so
                    # metrics.slowest(n) explains the p99
                    self.metrics.on_complete(
                        shape, latency, degraded=r.degraded or hedged,
                        breakdown={
                            "rid": r.id,
                            "shape": f"{b_pad}x{k_pad}",
                            "tier": answered,
                            "flush_reason": reason,
                            "queue_wait_ms": round(
                                max(t0 - r.submit_t, 0.0) * 1e3, 4),
                            "search_ms": round(
                                max(done_t - t0, 0.0) * 1e3, 4),
                        })
                    if (self.auditor is not None and not r.degraded
                            and not hedged and r.k == r.k_req):
                        self.auditor.maybe_sample(r.query, sub.indices[0],
                                                  sub.distances[0])
                    # hedged answers came from the degraded tier: never
                    # cached, same as natively degraded responses
                    if (self.cache is not None and not hedged
                            and r.cache_key is not None):
                        self.cache.put(r.cache_key, sub, version=version)
                    # deliver into the live ticket; a dropped ticket
                    # means the caller walked away — the response is
                    # dropped with it
                    tref = self._tickets.pop(r.id, None)
                    ticket = tref() if tref is not None else None
                    if ticket is not None:
                        ticket._response = resp
        return len(reqs)

    def _respond(self, rid: int, sub: SearchResult, step, *,
                 cached: bool = False, degraded: bool = False,
                 latency_s: float = 0.0) -> Response:
        valid = sub.indices >= 0
        payloads = step.values[np.where(valid, sub.indices, 0)]
        # invalid slots: PAD_DISTANCE (large finite) — weight ~0 under
        # an exp(-d) blend, NaN-safe in 0·d expressions; see batcher
        distances = np.where(valid, sub.distances,
                             PAD_DISTANCE).astype(np.float32)
        return Response(rid, "ok", result=sub, payloads=payloads,
                        valid=valid, distances=distances, cached=cached,
                        degraded=degraded, latency_s=latency_s)

    # -- ticket resolution ----------------------------------------------

    def _resolve(self, rid: int) -> None:
        """Force-flush the bucket holding ``rid``; the flush delivers
        the response into the (live) ticket that is asking."""
        bkey = self._pending.get(rid)
        if bkey is None:
            raise KeyError(f"unknown request id {rid}")
        self._flush(bkey, reason="forced")

    # -- streaming mutations (cache-invalidating) ------------------------

    def extend(self, new_keys, new_values):
        """``RetrievalStep.extend`` + hot-query cache invalidation —
        cached results may name pre-insert neighbors."""
        ids = self.step.extend(new_keys, new_values)
        if self.cache is not None:
            self.cache.invalidate()
        return ids

    def evict(self, ids) -> int:
        """``RetrievalStep.evict`` + hot-query cache invalidation —
        cached results may name tombstoned rows."""
        n = self.step.evict(ids)
        if self.cache is not None:
            self.cache.invalidate()
        return n

    # -- introspection ---------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def backpressure(self) -> bool:
        """True while queue depth sits past the admission watermark —
        the signal upstream producers should poll to slow down."""
        return self.queue_depth >= self.admission.watermark_depth

    @property
    def compile_shapes(self) -> set[tuple[int, int, str]]:
        """(B_pad, k_pad, tier) shapes executed so far — its size is
        the count of jit compiles the reference induces for the same
        traffic."""
        return set(self._seen_shapes)

    def snapshot(self) -> MetricsSnapshot:
        return self.metrics.snapshot(queue_depth=self.queue_depth)

    def __repr__(self) -> str:
        return (f"RequestScheduler(pending={self.queue_depth}, "
                f"shapes={len(self._seen_shapes)}, "
                f"cache={'on' if self.cache else 'off'}, "
                f"degraded_tier={'on' if self.degraded_step else 'off'})")
