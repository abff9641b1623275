"""The port's serving front end (``repro_torch.serve``) and dedup stage
(``repro_torch.data``) held against ``repro.serve`` and ``repro.data``.

Each scenario is a case of the reference's own tests (``test_serve.py``,
``test_resilience.py::TestServeHardening`` / ``TestNonfiniteFacade``,
the serve cases of ``test_obs.py``, ``test_metrics.py``,
``test_quality.py``, ``test_quant.py``, ``test_stream.py`` and the
dedup cases of ``test_system.py``), written once against a *side* — the
reference's modules or the port's — and run on both with the same
``make_clustered`` keys, the same fake clocks and the same chaos plans.
Both sides make the reference's assertions, and their records are then
held to each other:

* the port's step answers over an index carried from the JAX index
  (``FlatBackend.from_arrays`` with JAX's A, projection and SQ8 codec /
  codes; ``StreamingIndex.from_arrays`` with JAX's A), built on the CPU
  and set as ``step.index`` before the scheduler is built, so the cache
  trains its key codec on the same rows;
* bucket sizes, flush reasons, statuses and the cached / degraded /
  hedged outcomes are equal, ids identical, distances within rtol 1e-5
  (float) or 1e-4 (quantized);
* every ``MetricsSnapshot`` field — counters, quantiles and wall time,
  deterministic under the fake clocks — and the Prometheus text of the
  ``serve_*`` series are equal (each side's registry is a fresh one for
  the test), except the summed ``WorkStats`` of streaming datastores,
  whose PM-tree segments may count other node visits (ROADMAP queue C);
* the ``serve.*`` span tree is the reference's.

The reference's scheduler tests run on ``time.perf_counter``; here every
scheduler takes a ``TickingClock`` unless the reference's test injects
its own, so latencies are equal across the two runs.
"""
import dataclasses
import gc
import types

import numpy as np
import pytest
import torch

import repro.data.dedup as jdedup
import repro.obs.quality as jquality
import repro.serve as jserve
import repro.serve.metrics as jserve_metrics
import repro.serve.serve_step as jserve_step
from conftest import make_clustered
from repro.core.cp import PMLSH_CP as JaxPMLSH_CP
from repro.core.hashing import ProjectionFamily as JaxFamily
from repro.index import IndexConfig as JaxConfig
from repro.index import WorkStats as JaxWorkStats
from repro.index import build_index as jax_build_index
from repro.index.types import SearchResult as JaxSearchResult
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.quant import train_sq8 as jax_train_sq8
from repro.resilience import chaos as jchaos
from repro.resilience import recovery as jrecovery
from repro_torch import convert
from repro_torch.data import dedup as tdedup
from repro_torch.index import IndexConfig, get_backend
from repro_torch.index import WorkStats as TorchWorkStats
from repro_torch.index.types import SearchResult as TorchSearchResult
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import quality as tquality
from repro_torch.obs import trace as ttrace
from repro_torch.quant import train_sq8 as torch_train_sq8
from repro_torch.resilience import chaos as tchaos
from repro_torch.resilience import recovery as trecovery
from repro_torch.serve import metrics as tserve_metrics
from repro_torch.serve import serve_step as tserve_step
from repro_torch.stream import StreamingIndex
import repro_torch.serve as tserve

FLOAT_RTOL, QUANT_RTOL = 1e-5, 1e-4

JAX = types.SimpleNamespace(
    name="jax", serve=jserve, step=jserve_step, serve_metrics=jserve_metrics,
    chaos=jchaos, trace=jtrace, export=jexport, metrics=jmetrics, quality=jquality,
    recovery=jrecovery, SearchResult=JaxSearchResult, WorkStats=JaxWorkStats,
    train_sq8=jax_train_sq8)
TORCH = types.SimpleNamespace(
    name="torch", serve=tserve, step=tserve_step, serve_metrics=tserve_metrics,
    chaos=tchaos, trace=ttrace, export=texport, metrics=tmetrics, quality=tquality,
    recovery=trecovery, SearchResult=TorchSearchResult, WorkStats=TorchWorkStats,
    train_sq8=lambda rows: torch_train_sq8(rows, device="cpu"))
SIDES = (JAX, TORCH)


class FakeClock:
    """Injectable deterministic clock for deadline behavior."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class TickingClock(FakeClock):
    """Advances a fixed step on every read — gives flushes a nonzero,
    deterministic wall time."""

    def __call__(self) -> float:
        self.t += 0.002
        return self.t


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """A fresh metrics registry on each side for the test, so the
    ``serve_*`` exposition text holds only this test's operations."""
    regs = {}
    for side in SIDES:
        reg = side.metrics.MetricsRegistry()
        monkeypatch.setattr(side.metrics, "get_registry", lambda reg=reg: reg)
        regs[side.name] = reg
    return regs


# ---------------------------------------------------------------------------
# the two sides' steps over the same keys
# ---------------------------------------------------------------------------


def _carry(ji, keys, backend, options):
    """The port's index answering what the JAX index ``ji`` answers."""
    cfg = IndexConfig(backend=backend, seed=0, options=options)
    if backend == "streaming":
        a = np.asarray(JaxFamily.create(keys.shape[1], cfg.m, seed=0).a)
        return StreamingIndex.from_arrays(keys, a, cfg, device="cpu")
    codec = codes = None
    if getattr(ji, "codec", None) is not None:
        if hasattr(ji.codec, "centroids"):
            codec = convert.codec_from_arrays(centroids=np.asarray(ji.codec.centroids),
                                              d=ji.codec.d, device="cpu")
        else:
            codec = convert.codec_from_arrays(scale=np.asarray(ji.codec.scale),
                                              offset=np.asarray(ji.codec.offset),
                                              device="cpu")
        codes = np.asarray(ji.codes)
    return get_backend(backend).from_arrays(keys, np.asarray(ji.impl.family.a),
                                            np.asarray(ji.impl.projected), cfg, device="cpu",
                                            codec=codec, codes=codes)


def make_steps(n=256, d=16, k=8, backend="flat", keys=None, values=None, **options):
    """{side name: RetrievalStep} over the same keys and payloads, and the
    keys: the reference's step, and the port's on the CPU with the JAX
    index carried across."""
    keys = make_clustered(n, d, seed=3) if keys is None else keys
    values = np.arange(len(keys)) if values is None else values
    jstep, _ = jserve_step.make_retrieval_step(
        keys, values, k=k, index_config=JaxConfig(backend=backend, seed=0, options=options))
    # the port's own index is replaced at once: built flat, so no
    # streaming segment takes a serial from the process-wide counter
    # that the JAX side's counter must keep pace with
    tstep, _ = tserve_step.make_retrieval_step(
        keys, values, k=k, index_config=IndexConfig(backend="flat", seed=0), device="cpu")
    tstep.index = _carry(jstep.index, keys, backend, options)
    return {"jax": jstep, "torch": tstep}, keys


def both(scenario, steps=None, keys=None, **kw):
    """Run ``scenario(side, step, keys, **kw)`` on each side; returns the
    two records."""
    out = []
    for side in SIDES:
        out.append(scenario(side, None if steps is None else steps[side.name], keys, **kw))
    return out


def assert_same(a, b, rtol=FLOAT_RTOL, path="record"):
    """Records equal: ints, bools, strings and Python floats exactly, int
    arrays exactly, float arrays within ``rtol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), f"{path}: keys differ"
        for key in a:
            assert_same(a[key], b[key], rtol, f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def resp(r) -> dict:
    """One response: status, outcomes, latency, and the answer."""
    out = {"status": r.status, "cached": r.cached, "degraded": r.degraded,
           "latency_s": r.latency_s}
    if r.result is not None:
        out.update(ids=r.result.indices, d=r.result.distances, payloads=r.payloads,
                   valid=r.valid, dists=r.distances)
    return out


def snap(s, work: bool = True) -> dict:
    """Every MetricsSnapshot field and derived rate (the summed WorkStats
    unless ``work`` is False)."""
    out = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
           if f.name not in ("buckets", "work")}
    out["buckets"] = [dataclasses.astuple(b) + (b.padding_overhead,) for b in s.buckets]
    out.update(qps=s.qps, cache_hit_rate=s.cache_hit_rate, shed_rate=s.shed_rate,
               degraded_rate=s.degraded_rate, padding_overhead=s.padding_overhead,
               compile_rate=s.compile_rate)
    if work:
        out["work"] = s.work.as_dict()
    return out


def serve_text(side) -> list[str]:
    """The Prometheus exposition lines of the ``serve_*`` series."""
    return [line for line in side.metrics.get_registry().to_prometheus().splitlines()
            if line.split(" ")[0].startswith("serve_") or line.startswith(("# HELP serve_",
                                                                             "# TYPE serve_"))]


def sched_record(side, sched, responses, work=True) -> dict:
    return {"responses": [resp(r) for r in responses], "snapshot": snap(sched.snapshot(), work),
            "shapes": sorted(sched.compile_shapes), "prom": serve_text(side),
            "slowest": sched.metrics.slowest(5)}


# ---------------------------------------------------------------------------
# palette / batcher (test_serve.py::TestPalette)
# ---------------------------------------------------------------------------


def test_pow2_ladder():
    def run(S, *_):
        pow2_ceil, BucketPalette = S.serve.pow2_ceil, S.serve.BucketPalette
        assert [pow2_ceil(x) for x in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
        p = BucketPalette(b_max=8, k_max=16)
        assert p.k_pad(5) == 8 and p.k_pad(16) == 16 and p.k_pad(1) == 1
        assert p.b_pad(3) == 4 and p.b_pad(100) == 8  # clamped to b_max
        assert len(p.shapes) == 4 * 5
        with pytest.raises(ValueError):
            p.k_pad(17)
        with pytest.raises(ValueError):
            BucketPalette(b_max=6)
        return {"pads": [pow2_ceil(x) for x in range(1, 300)],
                "shapes": BucketPalette(b_max=64, k_max=128).shapes}

    assert_same(*both(run))


def test_mixed_k_buckets():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=8, k_max=16, cache=False), clock=TickingClock())
        tickets = [sched.submit(keys[i], k=k) for i, k in enumerate([3, 9, 1, 4, 16, 2])]
        sizes = {kp: len(b) for (kp, _), b in sched._buckets.items()}
        assert sizes == {4: 2, 16: 2, 1: 1, 2: 1}
        sched.drain()
        shapes = {b.shape for b in sched.snapshot().buckets}
        assert shapes == {(2, 4), (1, 1), (2, 16), (1, 2)}
        return {"sizes": sizes, **sched_record(S, sched, [t.result() for t in tickets])}

    assert_same(*both(run, steps, keys))


def test_staging_double_buffer():
    def run(S, *_):
        st = S.serve.StagingBuffers(4, 3)
        a = st.stage([np.ones(3, np.float32)])
        b = st.stage([np.full(3, 2.0, np.float32)])
        assert a is not b
        assert (a[0] == 1.0).all() and (b[0] == 2.0).all()
        assert (a[1:] == 0).all()
        c = st.stage([np.full(3, 3.0, np.float32)])
        assert c is a and st.reuses == 1
        return {"a": a.copy(), "b": b.copy(), "reuses": st.reuses}

    assert_same(*both(run))


# ---------------------------------------------------------------------------
# continuous batching (test_serve.py::TestBatching)
# ---------------------------------------------------------------------------


def test_full_bucket_flushes_immediately():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=4, cache=False), clock=TickingClock())
        tickets = [sched.submit(keys[i], k=5) for i in range(4)]
        assert all(t.done for t in tickets)
        assert sched.snapshot().full_flushes == 1
        return sched_record(S, sched, [t.result() for t in tickets])

    assert_same(*both(run, steps, keys))


def test_deadline_flush_fires_before_fill():
    steps, keys = make_steps()

    def run(S, step, keys):
        clock = FakeClock()
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=8, cache=False), clock=clock)
        t = sched.submit(keys[0], k=5, deadline_ms=5.0)
        assert sched.pump() == 0 and not t.done
        clock.advance(0.006)
        assert sched.pump() == 1 and t.done
        s = sched.snapshot()
        assert s.deadline_flushes == 1 and s.full_flushes == 0
        assert s.buckets[0].shape == (1, 8)
        return sched_record(S, sched, [t.result()])

    assert_same(*both(run, steps, keys))


def test_result_forces_flush():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=8, cache=False), clock=TickingClock())
        r = sched.submit(keys[7], k=3).result()
        assert r.ok and r.payloads[0, 0] == 7
        assert sched.snapshot().forced_flushes == 1
        return sched_record(S, sched, [r])

    assert_same(*both(run, steps, keys))


def test_responses_route_to_their_requests():
    steps, keys = make_steps(n=200)

    def run(S, step, keys):
        rng = np.random.default_rng(1)
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=4, cache=False), clock=TickingClock())
        ids = rng.integers(0, 200, size=50)
        tickets = [(i, sched.submit(keys[i] + 1e-4, k=int(rng.integers(1, 9)))) for i in ids]
        sched.drain()
        for i, t in tickets:
            r = t.result()
            assert r.ok and r.result.indices[0, 0] == i
            assert r.valid.shape == r.result.indices.shape
            assert np.isfinite(r.distances).all()
        return sched_record(S, sched, [t.result() for _, t in tickets])

    assert_same(*both(run, steps, keys))


def test_dropped_tickets_do_not_leak_responses():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=4, cache=False), clock=TickingClock())
        for i in range(8):
            sched.submit(keys[i], k=4)  # ticket dropped immediately
        gc.collect()
        sched.drain()
        assert sched.queue_depth == 0
        assert not sched._tickets
        assert sched.snapshot().completed == 8
        return sched_record(S, sched, [])

    assert_same(*both(run, steps, keys))


def test_service_estimate_scales_with_flush_width():
    steps, keys = make_steps()

    def run(S, step, keys):
        clock = FakeClock()
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=8, cache=False), clock=clock)
        sched._service_ewma[(8, "primary")] = 0.004
        t = sched.submit(keys[0], k=8, deadline_ms=10.0)
        assert sched.pump() == 0 and not t.done
        clock.advance(0.007)
        assert sched.pump() == 1 and t.done
        return {"ewma": dict(sched._service_ewma), **sched_record(S, sched, [t.result()])}

    assert_same(*both(run, steps, keys))


def test_flush_updates_per_slot_ewma():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=4, cache=False), clock=TickingClock())
        tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        assert sched._service_ewma[(4, "primary")] == pytest.approx(0.002 / 4)
        return {"ewma": dict(sched._service_ewma),
                **sched_record(S, sched, [t.result() for t in tickets])}

    assert_same(*both(run, steps, keys))


def test_search_convenience_matches_direct():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(cache=False),
                                         clock=TickingClock())
        res = sched.search(keys[:6] + 1e-4, k=8)
        direct = step.index.search(keys[:6] + 1e-4, k=8)
        np.testing.assert_array_equal(res.indices, direct.indices)
        np.testing.assert_allclose(res.distances, direct.distances, rtol=1e-5)
        return {"ids": res.indices, "d": res.distances, **sched_record(S, sched, [])}

    assert_same(*both(run, steps, keys))


# ---------------------------------------------------------------------------
# compile-shape stability (test_serve.py::TestCompileStability)
# ---------------------------------------------------------------------------


def test_one_compile_per_shape_on_ragged_trace():
    steps, keys = make_steps()

    def run(S, step, keys):
        rng = np.random.default_rng(2)
        seen_calls = []
        orig_search = step.index.search

        def spying_search(Q, k=None):
            seen_calls.append((np.atleast_2d(np.asarray(Q)).shape[0], int(k)))
            return orig_search(Q, k)

        step.index.search = spying_search
        clock = FakeClock()
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=8, k_max=16, cache=False, default_deadline_ms=3.0), clock=clock)
        tickets = []
        try:
            for i in range(500):
                k = int(rng.choice([1, 3, 5, 8, 10, 16]))
                tickets.append(sched.submit(keys[int(rng.integers(0, len(keys)))], k=k))
                if i % 7 == 0:
                    clock.advance(0.004)
                    sched.pump()
            sched.drain()
        finally:
            del step.index.search
        s = sched.snapshot()
        assert s.completed == s.submitted == 500
        distinct = set(seen_calls)
        palette = {(b, kp) for b in (1, 2, 4, 8) for kp in (1, 4, 8, 16)}
        assert distinct <= palette
        assert s.compile_misses == len(distinct) <= len(palette)
        total = s.full_flushes + s.deadline_flushes + s.forced_flushes
        assert s.compile_hits == total - s.compile_misses
        assert s.padding_overhead > 0 and s.staging_reuses > 0
        return {"calls": seen_calls, **sched_record(S, sched, [t.result() for t in tickets])}

    assert_same(*both(run, steps, keys))


# ---------------------------------------------------------------------------
# hot-query cache (test_serve.py::TestCache)
# ---------------------------------------------------------------------------


def test_hit_is_bit_identical():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=4),
                                         clock=TickingClock())
        first = sched.submit(keys[3], k=6).result()
        assert not first.cached
        second = sched.submit(keys[3], k=6).result()
        assert second.cached and second.ok
        np.testing.assert_array_equal(second.result.indices, first.result.indices)
        assert second.result.distances.tobytes() == first.result.distances.tobytes()
        s = sched.snapshot()
        assert s.cache_hits == 1 and s.cache_hit_rate == 0.5
        return sched_record(S, sched, [first, second])

    assert_same(*both(run, steps, keys))


def test_near_duplicate_shares_grid_cell():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=1),
                                         clock=TickingClock())
        first = sched.submit(keys[0], k=4).result()
        scale = np.asarray(sched.cache.codec.scale)
        nudged = keys[0] + 0.01 * scale.min()
        again = sched.submit(nudged, k=4).result()
        assert again.cached
        return {"scale": scale.tobytes(), "offset": np.asarray(sched.cache.codec.offset).tobytes(),
                "key": sched.cache.key(nudged, 4),
                **sched_record(S, sched, [first, again])}

    assert_same(*both(run, steps, keys))


def test_distinct_k_distinct_entries():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=1),
                                         clock=TickingClock())
        a = sched.submit(keys[0], k=4).result()
        b = sched.submit(keys[0], k=5).result()
        assert not b.cached
        return sched_record(S, sched, [a, b])

    assert_same(*both(run, steps, keys))


def test_invalidation_on_extend_and_evict():
    steps, keys = make_steps(backend="streaming", delta_threshold=64)

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=1),
                                         clock=TickingClock())
        probe = np.full(keys.shape[1], 23.0, np.float32)
        stale = sched.submit(probe, k=1).result()
        warm = sched.submit(probe, k=1).result()
        assert warm.cached
        ids = sched.extend(probe[None], [9999])
        fresh = sched.submit(probe, k=1).result()
        assert not fresh.cached
        assert fresh.result.indices[0, 0] == ids[0]
        assert fresh.result.indices[0, 0] != stale.result.indices[0, 0]
        hot = sched.submit(probe, k=1).result()
        assert hot.cached
        sched.evict(ids)
        after = sched.submit(probe, k=1).result()
        assert not after.cached and after.result.indices[0, 0] != ids[0]
        return {"ids": ids, "generation": sched.cache.generation,
                **sched_record(S, sched, [stale, warm, fresh, hot, after], work=False)}

    assert_same(*both(run, steps, keys))


def test_version_stamp_guards_out_of_band_mutation():
    steps, keys = make_steps(backend="streaming", delta_threshold=64)

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=1),
                                         clock=TickingClock())
        first = sched.submit(keys[0], k=2).result()
        step.extend(keys[:1] * 50, [777])  # not via the scheduler
        after = sched.submit(keys[0], k=2).result()
        assert not after.cached
        return {"version": step.version,
                **sched_record(S, sched, [first, after], work=False)}

    assert_same(*both(run, steps, keys))


def test_codes_only_datastore_keys_safely():
    steps, keys = make_steps(quant="sq8", store_raw=False)

    def run(S, step, keys):
        assert len(step.index.data) == 0
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(b_max=1),
                                         clock=TickingClock())
        assert sched.cache.codec is step.index.codec
        first = sched.submit(keys[0], k=4).result()
        far = sched.submit(keys[0] + 9.0, k=4).result()
        assert not far.cached
        again = sched.submit(keys[0], k=4).result()
        assert again.cached
        assert first.result.indices.shape == (1, 4)
        return sched_record(S, sched, [first, far, again])

    assert_same(*both(run, steps, keys), rtol=QUANT_RTOL)


def test_degenerate_codec_refused_exact_bytes_fallback():
    def run(S, *_):
        cache = S.serve.SQ8QueryCache(capacity=8)
        assert not cache.ensure_codec(None)
        assert not cache.ensure_codec(np.zeros((1, 4), np.float32))
        assert not cache.ensure_codec(np.ones((3, 4), np.float32))
        assert cache.codec is None
        q = np.zeros(4, np.float32)
        far = np.full(4, 9.0, np.float32)
        assert cache.key(q, 2) != cache.key(far, 2)
        assert cache.key(q, 2) == cache.key(q.copy(), 2)
        assert cache.key(q, 2) != cache.key(q, 3)
        return [cache.key(q, 2), cache.key(far, 3)]

    assert_same(*both(run))


def test_lru_capacity_bound():
    def run(S, *_):
        rng = np.random.default_rng(0)
        rows = rng.normal(size=(32, 4)).astype(np.float32)
        cache = S.serve.SQ8QueryCache(capacity=8, codec=S.train_sq8(rows))
        res = S.SearchResult(np.zeros((1, 2), np.int32), np.zeros((1, 2), np.float32))
        for i in range(20):
            cache.put(cache.key(rows[i], 2), res)
        assert len(cache) == 8 and cache.evictions == 12
        assert cache.get(cache.key(rows[19], 2)) is not None
        assert cache.get(cache.key(rows[0], 2)) is None
        return {"keys": list(cache._table), "counts": (cache.hits, cache.misses,
                                                      cache.insertions, cache.evictions)}

    assert_same(*both(run))


# ---------------------------------------------------------------------------
# admission control (test_serve.py::TestAdmission)
# ---------------------------------------------------------------------------


def test_bands():
    def run(S, *_):
        ADMIT, DEGRADE, SHED = S.serve.ADMIT, S.serve.DEGRADE, S.serve.SHED
        ctl = S.serve.AdmissionController(max_queue=10, watermark=0.5)
        assert ctl.decide(0) == ADMIT and not ctl.backpressure
        assert ctl.decide(4) == ADMIT
        assert ctl.decide(5) == DEGRADE and ctl.backpressure
        assert ctl.decide(10) == SHED
        shed_only = S.serve.AdmissionController(max_queue=10, watermark=0.5, policy=SHED)
        assert shed_only.decide(7) == ADMIT
        assert shed_only.decide(10) == SHED
        with pytest.raises(ValueError):
            S.serve.AdmissionController(watermark=0.0)
        with pytest.raises(ValueError):
            S.serve.AdmissionController(policy="drop")
        return [(ctl.decide(i), ctl.backpressure, shed_only.decide(i)) for i in range(12)]

    assert_same(*both(run))


def test_backpressure_and_shed_at_watermark():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=64, max_queue=10, watermark=0.5, shed_policy="shed", cache=False,
            default_deadline_ms=1e6), clock=TickingClock())
        tickets, pressure = [], []
        for i in range(25):
            tickets.append(sched.submit(keys[i % len(keys)], k=4))
            pressure.append(sched.backpressure)
        assert not pressure[3] and pressure[4]
        shed = [t for t in tickets if t.done and t.result().status == "shed"]
        assert len(shed) == 15
        s = sched.snapshot()
        assert s.shed == 15 and s.pending == 10
        assert s.submitted == s.completed + s.shed + s.pending
        before = snap(s)
        sched.drain()
        s = sched.snapshot()
        assert s.completed == 10 and s.pending == 0
        assert abs(s.shed_rate - 15 / 25) < 1e-9
        return {"pressure": pressure, "before": before,
                **sched_record(S, sched, [t.result() for t in tickets])}

    assert_same(*both(run, steps, keys))


def test_degrade_routes_to_quant_tier():
    keys = make_clustered(256, 16, seed=3)
    primary, _ = make_steps(keys=keys)
    cheap, _ = make_steps(keys=keys, quant="sq8", rerank=16)

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(
            step, degraded_step=cheap[S.name], clock=TickingClock(),
            config=S.serve.ServeConfig(b_max=64, max_queue=8, watermark=0.25, cache=False,
                                       default_deadline_ms=1e6))
        tickets = [sched.submit(keys[i] + 1e-4, k=4) for i in range(8)]
        sched.drain()
        degraded = [t.result() for t in tickets if t.result().degraded]
        assert len(degraded) == 6
        for r in degraded:
            assert r.ok and r.result.indices.shape == (1, 4)
        assert any(tier == "degraded" for _, _, tier in sched.compile_shapes)
        assert sched.snapshot().degraded == 6
        return sched_record(S, sched, [t.result() for t in tickets])

    assert_same(*both(run, primary, keys), rtol=QUANT_RTOL)


def test_degrade_clamps_k_without_tier():
    steps, keys = make_steps()

    def run(S, step, keys):
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=64, max_queue=8, watermark=0.25, cache=False, default_deadline_ms=1e6),
            clock=TickingClock())
        tickets = [sched.submit(keys[i], k=8) for i in range(6)]
        sched.drain()
        degraded = [t.result() for t in tickets if t.result().degraded]
        assert degraded
        for r in degraded:
            assert r.result.indices.shape == (1, 8)
            assert r.valid.sum() == 4
            assert (r.result.indices[0, 4:] == -1).all()
            assert (r.distances[0, 4:] == S.serve.PAD_DISTANCE).all()
        return sched_record(S, sched, [t.result() for t in tickets])

    assert_same(*both(run, steps, keys))


# ---------------------------------------------------------------------------
# RetrievalStep satellites (test_serve.py::TestRetrievalStepSatellites)
# ---------------------------------------------------------------------------


def test_extend_amortized_growth():
    steps, keys = make_steps(n=64, backend="streaming", delta_threshold=32)

    def run(S, step, keys):
        rng = np.random.default_rng(0)
        expect = list(range(64))
        ids = []
        for i in range(100):
            rows = rng.normal(size=(2, keys.shape[1])).astype(np.float32)
            ids.append(step.extend(rows, [1000 + 2 * i, 1001 + 2 * i]))
            expect += [1000 + 2 * i, 1001 + 2 * i]
        assert len(step.values) == 264
        np.testing.assert_array_equal(step.values, expect)
        assert step._value_reallocs <= 6
        assert step.version == 100
        payload, valid, dists, res = step(rng.normal(size=(5, keys.shape[1])).astype(np.float32))
        return {"ids": ids, "values": step.values.copy(), "reallocs": step._value_reallocs,
                "payload": payload, "valid": valid, "dists": dists}

    assert_same(*both(run, steps, keys))


def test_values_setter_back_compat():
    steps, keys = make_steps(n=16)

    def run(S, step, keys):
        step.values = np.arange(16) * 2
        assert (step.values == np.arange(16) * 2).all()
        return step(keys[:3])[0]

    assert_same(*both(run, steps, keys))


def test_invalid_slots_neutralized():
    keys = np.eye(3, dtype=np.float32)
    steps, _ = make_steps(keys=keys, values=np.array([10, 11, 12]), k=5)

    def run(S, step, keys):
        payload, valid, dists, res = step(keys[:2])
        assert valid.sum(axis=1).tolist() == [3, 3]
        assert np.isinf(res.distances[~valid]).all()
        assert (dists[~valid] == S.serve.PAD_DISTANCE).all()
        assert np.isfinite(dists).all()
        w = np.exp(-(dists - dists.min(axis=1, keepdims=True)))
        assert (w[~valid] == 0.0).all()
        assert (payload[~valid] == 10).all()
        return {"payload": payload, "valid": valid, "dists": dists, "ids": res.indices}

    assert_same(*both(run, steps, keys))


# ---------------------------------------------------------------------------
# serve hardening (test_resilience.py::TestServeHardening)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hardening_steps():
    keys = make_clustered(256, 16, seed=3)
    primary, _ = make_steps(keys=keys)
    cheap, _ = make_steps(keys=keys, quant="sq8", rerank=16)
    return primary, cheap, keys


def _hardened(S, steps, degraded=False, **cfg):
    primary, cheap, _ = steps
    cfg.setdefault("default_deadline_ms", 1e6)
    sched = S.serve.RequestScheduler(
        primary[S.name], degraded_step=cheap[S.name] if degraded else None,
        config=S.serve.ServeConfig(b_max=4, cache=False, **cfg), clock=TickingClock())
    sched._sleep = lambda s: None  # no real backoff in tests
    return sched


def _hardening(scenario, steps, rtol=QUANT_RTOL):
    keys = steps[2]
    out = [scenario(S, keys) for S in SIDES]
    assert_same(*out, rtol=rtol)
    return out


def test_nonfinite_query_rejected_at_submit(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        q = keys[0].copy()
        q[3] = np.nan
        with pytest.raises(S.serve.RejectedQuery) as ei:
            sched.submit(q, k=4)
        assert ei.value.reason == "nonfinite"
        s = sched.snapshot()
        assert s.rejected == 1 and s.submitted == 0
        return {"msg": str(ei.value), **sched_record(S, sched, [])}

    _hardening(run, hardening_steps)


def test_batch_submit_isolates_rejects(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        Q = keys[:3].copy()
        Q[1, 0] = np.inf
        tickets = sched.submit_batch(Q, k=4)
        sched.drain()
        assert [t.result().status for t in tickets] == ["ok", "rejected", "ok"]
        s = sched.snapshot()
        assert s.rejected == 1 and s.completed == 2 and s.submitted == s.completed
        return sched_record(S, sched, [t.result() for t in tickets])

    _hardening(run, hardening_steps)


def test_transient_error_retried_once(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.search", "error", at=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        assert all(t.result().ok for t in tickets)
        s = sched.snapshot()
        assert s.retries == 1 and s.hedges == 0 and s.failed == 0
        return {"fired": plan.fired(), **sched_record(S, sched, [t.result() for t in tickets])}

    _hardening(run, hardening_steps)


def test_persistent_error_hedges_to_degraded_tier(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps, degraded=True)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.search", "error", prob=1.0,
                                                    times=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        resps = [t.result() for t in tickets]
        assert all(r.ok and r.degraded for r in resps)
        s = sched.snapshot()
        assert s.retries == 1 and s.hedges == 1
        assert sched.breaker.state == "closed"
        return {"fired": plan.fired(), **sched_record(S, sched, resps)}

    _hardening(run, hardening_steps)


def test_exhausted_ladder_quarantines_and_fails_solo(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.search", "error", prob=1.0,
                                                    times=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        resps = [t.result() for t in tickets]
        assert [r.status for r in resps] == ["failed"] * 4
        s = sched.snapshot()
        assert s.failed == 4 and s.pending == 0 and s.quarantine_flushes >= 2
        assert s.submitted == s.completed + s.shed + s.failed
        return {"fired": plan.fired(), **sched_record(S, sched, resps)}

    _hardening(run, hardening_steps)


def test_open_breaker_blocks_hedge(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps, degraded=True)
        for _ in range(4):
            sched.breaker.record_failure()
        assert sched.breaker.state == "open"
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.search", "error", prob=1.0,
                                                    times=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        assert all(t.result().status == "failed" for t in tickets)
        assert sched.snapshot().hedges == 0
        return sched_record(S, sched, [t.result() for t in tickets])

    _hardening(run, hardening_steps)


def test_latency_spike_past_deadline_triggers_ladder(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps, degraded=True, default_deadline_ms=50.0)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.search", "latency", prob=1.0,
                                                    times=0, latency_s=30.0)])
        slept = []
        plan.sleep = slept.append  # model the stall, skip the wait
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        resps = [t.result() for t in tickets]
        assert all(r.ok and r.degraded for r in resps)
        assert sched.snapshot().hedges == 1
        return {"slept": slept, **sched_record(S, sched, resps)}

    _hardening(run, hardening_steps)


def test_dropped_flush_leaves_requests_queued(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.flush", "drop", at=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
            assert not any(t.done for t in tickets)
            sched.drain()
        assert all(t.result().ok for t in tickets)
        return sched_record(S, sched, [t.result() for t in tickets])

    _hardening(run, hardening_steps)


def test_overfull_bucket_after_drop_flushes_in_chunks(hardening_steps):
    def run(S, keys):
        sched = _hardened(S, hardening_steps)
        plan = S.chaos.FaultPlan([S.chaos.FaultSpec("serve.flush", "drop", at=0)])
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i], k=4) for i in range(4)]
            assert not any(t.done for t in tickets)
            tickets += [sched.submit(keys[4 + i], k=4) for i in range(5)]
        sched.drain()
        assert all(t.result().ok for t in tickets)
        assert sched.snapshot().completed == 9
        return sched_record(S, sched, [t.result() for t in tickets])

    _hardening(run, hardening_steps)


def test_resilience_metrics_exported(hardening_steps):
    def run(S, keys):
        S.recovery._metrics()  # WAL/recovery metrics register on first durable use
        sched = _hardened(S, hardening_steps, degraded=True)
        tickets = [sched.submit(keys[i], k=4) for i in range(4)]
        text = S.metrics.get_registry().to_prometheus()
        for name in ("serve_retries_total", "serve_hedges_total", "serve_breaker_state",
                     "wal_fsync_seconds", "recovery_replayed_total"):
            assert name in text
        return {"text": text, **sched_record(S, sched, [t.result() for t in tickets])}

    _hardening(run, hardening_steps)


def test_seeded_chaos_plan_replays_the_reference_s(hardening_steps):
    """A seeded drill plan over the serve sites (the chaos pass of
    chip_smoke.py, at a small size): the same faults fire at the same
    accesses, and the ladder answers them the same way."""
    def run(S, keys):
        sched = _hardened(S, hardening_steps, degraded=True, default_deadline_ms=20.0)
        plan = S.chaos.FaultPlan.seeded(
            5, sites=("serve.search", "serve.degraded", "serve.flush"), prob=0.3)
        plan.sleep = lambda s: None
        with S.chaos.active(plan):
            tickets = [sched.submit(keys[i % 256] + 1e-3, k=1 + i % 7) for i in range(64)]
            sched.pump()
            sched.drain()
        s = sched.snapshot()
        assert s.completed + s.shed + s.failed == s.submitted == 64
        return {"fired": plan.fired(), **sched_record(S, sched, [t.result() for t in tickets])}

    jrec, _ = _hardening(run, hardening_steps)
    assert sum(jrec["fired"].values()) > 0


# ---------------------------------------------------------------------------
# the facade's non-finite masking (test_resilience.py::TestNonfiniteFacade)
# ---------------------------------------------------------------------------


def test_nonfinite_rows_masked_to_sentinel():
    data = make_clustered(400, 12, n_clusters=8, seed=0)
    ji = jax_build_index(np.asarray(data[:200]), backend="flat", seed=0)
    ti = _carry(ji, np.asarray(data[:200]), "flat", {})
    out = []
    for idx in (ji, ti):
        Q = np.asarray(data[200:205]).copy()
        Q[1, 3] = np.nan
        Q[4, 0] = np.inf
        res = idx.search(Q, k=5)
        assert (res.indices[[1, 4]] == -1).all()
        assert np.isinf(res.distances[[1, 4]]).all()
        assert res.stats.queries_rejected == 2
        clean = idx.search(np.where(np.isfinite(Q), Q, 0.0), k=5)
        for row in (0, 2, 3):
            np.testing.assert_array_equal(res.indices[row], clean.indices[row])
        out.append({"ids": res.indices, "d": res.distances, "work": res.stats.as_dict()})
    assert_same(*out)


def test_queries_rejected_sums_and_survives_roundtrip():
    def run(S, *_):
        a = S.WorkStats(queries_rejected=2)
        b = S.WorkStats(queries_rejected=3)
        total = a + b
        assert total.queries_rejected == 5
        assert S.WorkStats.from_dict(total.as_dict()).queries_rejected == 5
        assert S.WorkStats.from_dict({"bogus": 1}).queries_rejected == 0
        return total.as_dict()

    assert_same(*both(run))


# ---------------------------------------------------------------------------
# spans, reservoirs and the metrics registry (test_obs.py, test_metrics.py)
# ---------------------------------------------------------------------------


def test_serve_flush_trace():
    """test_obs.py::TestEngineTraces::test_serve_flush_trace: the same
    span tree — names, parents, attribute names, and every attribute
    that is not a time — on the real clock (queue-wait spans are
    emitted only under ``time.perf_counter``), the port's own spans
    (``serve.submit``, ``index.validate``, ``sync.*``) left out."""
    data = make_clustered(2048, 24)
    steps, _ = make_steps(keys=data[:512], values=np.arange(512, dtype=np.float32))
    trees = []
    for S in SIDES:
        sched = S.serve.RequestScheduler(steps[S.name], config=S.serve.ServeConfig(
            b_max=8, default_deadline_ms=1e6, max_queue=4096))
        with S.trace.trace() as tr:
            tickets = [sched.submit(data[i], k=4) for i in range(12)]
            sched.drain()
            [t.result() for t in tickets]
        if S is TORCH:  # the port-only spans left out
            tr = S.trace.Trace(S.trace.reference_view(tr))
        names = [s.name for s in tr.spans]
        for stage in ("serve.flush", "serve.stage", "serve.search", "serve.deliver",
                      "serve.queue_wait", "index.search"):
            assert stage in names
        assert S.export.coverage(tr) >= 0.95
        flush = tr.spans[names.index("serve.flush")]
        assert flush.attrs["real"] > 0 and "queue_wait_mean_ms" in flush.attrs
        assert flush.attrs["work"]["rounds"] >= 0
        S.export.validate_chrome_trace(S.export.to_chrome_trace(tr))
        timed = ("queue_wait_mean_ms", "queue_wait_max_ms")
        trees.append([(s.name, s.parent, sorted(s.attrs),
                       {k: v for k, v in s.attrs.items() if k not in timed})
                      for s in tr.spans])
    assert_same(*trees)


def test_reservoir_100k_observations_bounded():
    def run(S, *_):
        r = S.serve_metrics.LatencyReservoir(cap=512, seed=3)
        for i in range(100_000):
            r.observe(float(i % 1000))
        assert len(r) <= 512 and r.count == 100_000
        return r.samples()

    assert_same(*both(run))


def test_reservoir_quantiles_stay_stable():
    def run(S, *_):
        r = S.serve_metrics.LatencyReservoir(cap=2048, seed=1)
        xs = np.random.default_rng(0).uniform(0.0, 1.0, size=50_000)
        for x in xs:
            r.observe(float(x))
        p50, p99 = S.serve_metrics._quantiles_us(r)
        assert abs(p50 - 0.5e6) < 0.05e6 and abs(p99 - 0.99e6) < 0.03e6
        return (p50, p99)

    assert_same(*both(run))


def test_serve_metrics_memory_bounded():
    def run(S, *_):
        m = S.serve_metrics.ServeMetrics(clock=lambda: 0.0, latency_cap=256)
        m._latencies = S.serve_metrics.LatencyReservoir(256, seed=9)
        for i in range(100_000):
            m.on_complete((8, 16), latency_s=0.001 * (i % 7))
        assert len(m._latencies) <= 256
        assert len(m._buckets[(8, 16)][3]) <= 256
        s = m.snapshot()
        assert s.completed == 100_000 and s.p50_us > 0
        return {"completed": s.completed, "p50": s.p50_us, "p99": s.p99_us,
                "prom": serve_text(S)}

    assert_same(*both(run))


def test_reservoir_small_stream_kept_verbatim():
    def run(S, *_):
        r = S.serve_metrics.LatencyReservoir(cap=100)
        for x in (1.0, 2.0, 3.0):
            r.observe(x)
        assert r.samples() == [1.0, 2.0, 3.0]
        return S.serve_metrics._quantiles_us(r.samples())

    assert_same(*both(run))


def test_reservoir_default_seeds_are_independent():
    def run(S, *_):
        a, b = S.serve_metrics.LatencyReservoir(cap=32), S.serve_metrics.LatencyReservoir(cap=32)
        c, d = (S.serve_metrics.LatencyReservoir(cap=32, seed=7),
                S.serve_metrics.LatencyReservoir(cap=32, seed=7))
        for i in range(4096):
            for r in (a, b, c, d):
                r.observe(float(i))
        assert a.samples() != b.samples()
        assert c.samples() == d.samples()
        return c.samples()

    assert_same(*both(run))


def test_serve_metrics_events_mirrored():
    def run(S, *_):
        r = S.metrics.MetricsRegistry()
        m = S.serve_metrics.ServeMetrics(clock=lambda: 0.0, registry=r)
        m.on_submit(3)
        m.on_shed()
        m.on_cache_miss()
        m.on_flush((8, 16), real=5, reason="deadline")
        m.on_complete((8, 16), 0.002, breakdown={"queue_wait_ms": 1.0, "search_ms": 0.8})
        m.on_cache_hit(0.0001)
        m.on_compile(hit=False)
        assert r.get("serve_requests_total").get(event="submitted") == 3
        assert r.get("serve_requests_total").get(event="shed") == 1
        assert r.get("serve_requests_total").get(event="completed") == 2
        assert r.get("serve_cache_total").get(outcome="hit") == 1
        assert r.get("serve_flushes_total").get(reason="deadline") == 1
        assert r.get("serve_compile_total").get(outcome="miss") == 1
        top = m.slowest(1)
        assert top and top[0][1]["search_ms"] == 0.8
        return {"text": r.to_prometheus(), "top": top}

    assert_same(*both(run))


def test_serve_candidates_selected_total():
    def run(S, *_):
        r = S.metrics.MetricsRegistry()
        m = S.serve_metrics.ServeMetrics(clock=lambda: 0.0, registry=r)
        m.add_work(S.WorkStats(candidates_selected=120))
        m.add_work(S.WorkStats(candidates_selected=80))
        assert r.get("serve_candidates_selected_total").get() == 200
        assert m.work.candidates_selected == 200
        return r.to_prometheus()

    assert_same(*both(run))


# ---------------------------------------------------------------------------
# the quality auditor behind the scheduler (test_quality.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 2])
def test_scheduler_auditor(budget):
    """``TestSchedulerAuditor``: every delivered answer is offered to the
    auditor (sample_fraction 1), and an idle pump audits at most
    ``audit_budget`` of the queued samples."""
    data = make_clustered(256, 16, seed=3)
    steps, _ = make_steps(keys=data)
    recs = []
    for S in SIDES:
        step = steps[S.name]
        kw = {} if S is JAX else {"device": "cpu"}
        aud = S.quality.QualityAuditor.for_index(step.index, sample_fraction=1.0,
                                                 registry=S.metrics.MetricsRegistry(), **kw)
        sched = S.serve.RequestScheduler(step, config=S.serve.ServeConfig(
            b_max=4 if budget else 8, k_max=16, cache=False, default_deadline_ms=1e6,
            max_queue=1024), auditor=aud, clock=TickingClock(),
            **({"audit_budget": budget} if budget else {}))
        count = 8 if budget else 24
        tickets = [sched.submit(data[i] + 0.01, k=5) for i in range(count)]
        sched.drain()
        assert all(t.result().ok for t in tickets)
        audited = [aud.audited]
        if budget:
            before = aud.audited
            sched.pump()
            assert aud.audited - before <= 2
            while aud.pending:
                sched.pump()
                audited.append(aud.audited)
            assert aud.audited == aud.sampled == 8
        else:
            aud.audit()
            rep = aud.report()
            assert aud.sampled == 24 and rep.audited == 24 and rep.pending == 0
            assert rep.recall == 1.0
        assert aud.audited == aud.sampled - aud.pending
        rep = aud.report()
        # the ratio is a mean of answer distances over exact ones: float rtol
        recs.append({"audited": audited, "recall": rep.recall, "ratio": np.array(rep.ratio),
                     **sched_record(S, sched, [t.result() for t in tickets])})
    assert_same(*recs)


# ---------------------------------------------------------------------------
# quantized datastores (test_quant.py::TestServeQuantizedDatastore)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quant_data():
    dataset = make_clustered(1500, 32, n_clusters=20, seed=0)
    rng = np.random.default_rng(1)
    return dataset, dataset[rng.integers(0, len(dataset), 7)] + 0.05


def test_retrieval_step_over_quantized_keys(quant_data):
    dataset, queries = quant_data
    values = np.arange(len(dataset), dtype=np.int64) * 10
    steps, _ = make_steps(keys=dataset, values=values, k=5, backend="flat-pq",
                          use_kernels=False)

    def run(S, step, keys):
        payloads, valid, distances, res = step(queries)
        assert payloads.shape == (len(queries), 5) and valid.all()
        np.testing.assert_array_equal(payloads, res.indices * 10)
        assert step.key_bytes_per_point < 4.0 * dataset.shape[1]
        assert step.key_raw_bytes_per_point == 4.0 * dataset.shape[1]
        return {"payloads": payloads, "valid": valid, "dists": distances,
                "bytes": (step.key_bytes_per_point, step.key_raw_bytes_per_point)}

    assert_same(*both(run, steps, dataset), rtol=QUANT_RTOL)


def test_codes_only_datastore_drops_raw_keys(quant_data):
    dataset, queries = quant_data
    steps, _ = make_steps(keys=dataset, k=3, quant="sq8", store_raw=False, use_kernels=False)

    def run(S, step, keys):
        assert step.key_raw_bytes_per_point == 0.0
        payloads, valid, distances, _ = step(queries)
        return {"bytes": (step.key_bytes_per_point, step.key_raw_bytes_per_point),
                "payloads": payloads, "dists": distances}

    assert_same(*both(run, steps, dataset), rtol=QUANT_RTOL)


def test_float_datastore_reports_full_bytes(quant_data):
    dataset, queries = quant_data
    steps, _ = make_steps(keys=dataset[:200], k=3, use_kernels=False)

    def run(S, step, keys):
        assert step.key_bytes_per_point == 4.0 * dataset.shape[1]
        return {"bytes": step.key_bytes_per_point, "answer": step(queries)[:3]}

    assert_same(*both(run, steps, dataset))


# ---------------------------------------------------------------------------
# streaming datastores (test_stream.py::TestServing)
# ---------------------------------------------------------------------------


def test_retrieval_step_grows_online():
    keys = np.random.default_rng(0).normal(size=(200, 16)).astype(np.float32)
    steps, _ = make_steps(keys=keys, k=4, backend="streaming", segment_backend="flat",
                          delta_threshold=64)

    def run(S, step, keys):
        payload, valid, dists, res = step(keys[:3] + 0.001)
        assert payload.shape == valid.shape == dists.shape == (3, 4)
        assert valid.all() and (payload[:, 0] == [0, 1, 2]).all()
        far = np.full((2, 16), 41.0, np.float32)
        ids = step.extend(far, [900, 901])
        grown = step(far[:1])
        assert grown[0][0, 0] in (900, 901)
        step.evict(ids)
        after = step(far[:1])
        assert 900 not in after[0][0][after[1][0]] and 901 not in after[0][0][after[1][0]]
        return {"first": (payload, valid, dists), "ids": ids, "grown": grown[:3],
                "after": after[:3]}

    assert_same(*both(run, steps, keys))


def test_validity_mask_guards_padding():
    keys = np.eye(3, dtype=np.float32)
    steps, _ = make_steps(keys=keys, values=np.array([10, 11, 12]), k=5)

    def run(S, step, keys):
        payload, valid, dists, res = step(keys[:1])
        assert valid[0].sum() == 3
        assert (res.indices[0][~valid[0]] == -1).all()
        assert np.isinf(res.distances[0][~valid[0]]).all()
        assert (dists[0][~valid[0]] == S.serve.PAD_DISTANCE).all()
        assert np.isfinite(dists).all()
        return {"payload": payload, "valid": valid, "dists": dists}

    assert_same(*both(run, steps, keys))


# ---------------------------------------------------------------------------
# the dedup stage (test_system.py::TestDedupPipeline)
# ---------------------------------------------------------------------------


def _dedup_pair(monkeypatch, emb, threshold, seed=0, c=2.0):
    """(reference pairs, the port's pairs): the port's ``PMLSH_CP`` is
    handed JAX's A and projection (its draw is torch's), so both stages
    build one tree."""
    jcp = JaxPMLSH_CP(emb, c=c, m=min(15, emb.shape[1]), seed=seed)
    real = tdedup.PMLSH_CP
    monkeypatch.setattr(tdedup, "PMLSH_CP", lambda *a, **kw: real(
        *a, **kw, a=np.asarray(jcp.family.a), projected=np.asarray(jcp.projected)))
    jp = jdedup.find_near_duplicates(emb, threshold=threshold, seed=seed)
    tp = tdedup.find_near_duplicates(emb, threshold=threshold, seed=seed, device="cpu")
    assert [p[:2] for p in tp] == [p[:2] for p in jp]
    np.testing.assert_allclose([p[2] for p in tp], [p[2] for p in jp], rtol=FLOAT_RTOL)
    return jp, tp


def test_find_and_drop_near_duplicates(monkeypatch):
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 1000, 64) for _ in range(60)]
    for i in range(5):
        dup = docs[i].copy()
        dup[3] = (dup[3] + 1) % 1000
        docs.append(dup)
    emb = tdedup.embed_docs(docs, dim=64)
    np.testing.assert_array_equal(emb, jdedup.embed_docs(docs, dim=64))
    _, pairs = _dedup_pair(monkeypatch, emb, 0.3)
    found = {tuple(sorted((i, j))) for i, j, _ in pairs}
    planted = {(i, 60 + i) for i in range(5)}
    assert len(found & planted) >= 4, f"found {found}"
    keep = tdedup.dedup_mask(len(docs), pairs)
    np.testing.assert_array_equal(keep, jdedup.dedup_mask(len(docs), pairs))
    assert keep.sum() <= len(docs) - 4


def test_no_false_positives_on_distinct_docs(monkeypatch):
    rng = np.random.default_rng(1)
    docs = [rng.integers(0, 10_000, 128) for _ in range(50)]
    emb = tdedup.embed_docs(docs, dim=64)
    np.testing.assert_array_equal(emb, jdedup.embed_docs(docs, dim=64))
    jp, tp = _dedup_pair(monkeypatch, emb, 0.05)
    assert len(tp) == len(jp) == 0


# ---------------------------------------------------------------------------
# the cache's key codec, bit for bit; the port's entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["clustered", "wide_range", "constant_dims", "two_rows",
                                  "far_offset"])
def test_key_codec_is_jax_train_sq8_bit_for_bit(case):
    """The cache trains its key codec with ``quant.train_sq8`` on host
    rows; the grid equals JAX's ``train_sq8`` on the same rows bit for
    bit, and so every key of every query."""
    rng = np.random.default_rng(11)
    rows = {"clustered": make_clustered(700, 24, seed=4),
            "wide_range": (rng.normal(size=(300, 16)) * 10.0 ** rng.integers(-6, 7, 16)
                           ).astype(np.float32),
            "constant_dims": np.concatenate([rng.normal(size=(50, 5)),
                                             np.full((50, 3), 2.5)], 1).astype(np.float32),
            "two_rows": rng.normal(size=(2, 9)).astype(np.float32),
            "far_offset": make_clustered(500, 12, seed=5) * 1e-3 + 1e4}[case]
    j = jax_train_sq8(rows)
    t = torch_train_sq8(rows, device="cpu")
    assert np.asarray(j.scale).tobytes() == t.scale.numpy().tobytes()
    assert np.asarray(j.offset).tobytes() == t.offset.numpy().tobytes()
    jc, tc = jserve.SQ8QueryCache(codec=j), tserve.SQ8QueryCache()
    assert tc.ensure_codec(rows)
    near = rows[np.arange(20) % len(rows)]
    qs = np.concatenate([near + rng.normal(size=near.shape).astype(np.float32),
                         rows[:5] * 3.0])
    for q in qs:
        assert tc.key(q, 7) == jc.key(q, 7)


def test_key_codec_refuses_what_the_reference_refuses():
    for rows in (np.zeros((1, 4), np.float32), np.ones((3, 4), np.float32),
                 np.zeros((0, 4), np.float32), np.zeros(4, np.float32)):
        assert not tserve.SQ8QueryCache().ensure_codec(rows)
        assert not jserve.SQ8QueryCache().ensure_codec(rows)


def test_cache_trains_on_the_host_rows_of_a_flat_index():
    """The scheduler hands the cache the facade's host rows
    (``index.data``), as the reference does; the codec equals the
    reference's and lives on the host, where keys are computed."""
    steps, keys = make_steps()
    tsched = tserve.RequestScheduler(steps["torch"])
    jsched = jserve.RequestScheduler(steps["jax"])
    assert isinstance(steps["torch"].index.data, np.ndarray)
    assert tsched.cache.codec.scale.device.type == "cpu"
    np.testing.assert_array_equal(tsched.cache._scale, np.asarray(jsched.cache.codec.scale))
    np.testing.assert_array_equal(tsched.cache._offset, np.asarray(jsched.cache.codec.offset))


@pytest.mark.parametrize("entry", ["make_retrieval_step", "RetrievalStep",
                                   "find_near_duplicates"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works here")
    keys = make_clustered(64, 8, seed=1)
    call = {"make_retrieval_step": lambda: tserve_step.make_retrieval_step(keys, np.arange(64)),
            "RetrievalStep": lambda: tserve.RetrievalStep(keys, np.arange(64)),
            "find_near_duplicates": lambda: tdedup.find_near_duplicates(keys)}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_exports_match_the_reference_and_lm_steps_name_their_slice():
    """Every export of the reference, the model steps included (ported
    with the LM's serving side); the encoder-decoder's steps build too,
    with the reference's info keys and its frames among the batch
    inputs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import make_host_mesh

    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    assert tserve.make_retrieval_step is tserve_step.make_retrieval_step
    mesh = make_host_mesh(device="cpu")
    cfg = get_smoke_config("whisper_base")
    for name in ("make_prefill", "make_decode_step"):
        step = getattr(tserve, name)
        assert step is getattr(tserve_step, name)
        fn, info = step(cfg, mesh, batch=1, max_seq=8,
                        **({"seq_len": 8} if name == "make_prefill" else {}))
        assert callable(fn)
        assert set(info) == {"params", "batch", "cache", "abstract_params", "cache_specs",
                             "batch_specs", "lsh_shard"}  # the reference's, and the form
        assert info["lsh_shard"] is None  # the encoder-decoder: never the sharded decode
        assert info["cache"]["cross"][0]["ck"] == (1, cfg.n_audio_frames, cfg.n_kv_heads,
                                                   cfg.head_dim)
        if name == "make_prefill":
            assert info["batch"]["audio_frames"] == (1, cfg.n_audio_frames, cfg.d_model)
    with pytest.raises(AttributeError):
        tserve.no_such_name  # noqa: B018
