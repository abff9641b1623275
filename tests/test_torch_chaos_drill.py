"""``scripts/torch_chaos_drill.py`` held to ``scripts/chaos_drill.py`` at
seed 0, both loaded by path.

* The durability drill: seeded kill points, the mid-script snapshot, the
  torn WAL tail and the bit-flipped snapshot on each side, each recovery
  held by the drill itself to a never-crashed twin of its own framework;
  the two sides crash as often and replay as many WAL records.
* The serve drill under an injected ``TickingClock``: the port's passes
  its gates (accounting, p99, breaker trip, Prometheus needles), and,
  with the reference's JAX steps carried across (``FlatBackend.
  from_arrays`` with the JAX A, projection and SQ8 codec / codes) and
  the same clock on each side, every ticket's status and answer, the
  drill's statistics and every scheduler counter equal the reference's.
  Each side's metrics registry is a fresh one for the test.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.obs import metrics as jmetrics
from repro_torch.index import IndexConfig
from repro_torch.obs import metrics as tmetrics
from repro_torch.resilience import chaos as tchaos
from repro_torch.serve import serve_step as tserve_step
from test_torch_quickstart import load
from test_torch_serve import TickingClock, _carry

REF = load("scripts/chaos_drill.py", "jax_chaos_drill")
TWIN = load("scripts/torch_chaos_drill.py", "torch_chaos_drill")


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    for side in (jmetrics, tmetrics):
        reg = side.MetricsRegistry()
        monkeypatch.setattr(side, "get_registry", lambda reg=reg: reg)


def test_durability_drill_matches_the_reference(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = REF.durability_drill(0, tmp_path / "jax")
    got = TWIN.durability_drill(0, tmp_path / "torch", "cpu")
    assert got["crashes"] == want["crashes"] == 3
    assert got["records_replayed"] == want["records_replayed"] > 0


def test_serve_drill_passes_its_gates_under_a_ticking_clock():
    stats = TWIN.serve_drill(0, "cpu", clock=TickingClock())
    assert stats["breaker_transitions"] >= 1
    assert stats["p99_chaos_ms"] <= max(TWIN.DRILL_P99_FACTOR * stats["p99_base_ms"],
                                        stats["p99_base_ms"] + 3.0)


def _recording(monkeypatch, mod, traces):
    """Keep each trace's per-ticket status, outcome and answer."""
    run = mod._run_trace

    def wrapped(sched, queries):
        resps, lat = run(sched, queries)
        traces.append([(r.status, r.cached, r.degraded, r.latency_s,
                        None if r.result is None else r.result.indices.tolist())
                       for r in resps])
        return resps, lat

    monkeypatch.setattr(mod, "_run_trace", wrapped)


def _counters(sched) -> dict:
    s = sched.snapshot()
    out = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
           if f.name not in ("buckets", "work")}
    out["buckets"] = [dataclasses.astuple(b) for b in s.buckets]
    out["shapes"] = sorted(sched.compile_shapes)
    out["breaker"] = (sched.breaker.state, sched.breaker.transitions)
    return out


def test_serve_drill_matches_the_reference_scheduler(monkeypatch):
    scheds = {}

    def scheduler(name, cls, **inject):
        def make(*args, **kw):
            scheds[name] = cls(*args, **{**kw, **inject})
            return scheds[name]
        return make

    traces = {"jax": [], "torch": []}
    _recording(monkeypatch, REF, traces["jax"])
    _recording(monkeypatch, TWIN, traces["torch"])
    # the reference's scheduler reads its clock from a TickingClock too
    monkeypatch.setattr(jserve, "RequestScheduler",
                        scheduler("jax", jserve.RequestScheduler, clock=TickingClock()))
    want = REF.serve_drill(0)

    jsched = scheds["jax"]
    keys = np.asarray(jsched.step.index.data)

    def carried(seed, device):
        assert seed == 0 and str(device) == "cpu"
        steps = []
        for jstep, options in ((jsched.step, {}),
                               (jsched.degraded_step, {"quant": "sq8", "rerank": 32})):
            tstep, _ = tserve_step.make_retrieval_step(
                keys, np.arange(len(keys)), k=16, index_config=IndexConfig(
                    backend="flat", seed=0), device="cpu")
            tstep.index = _carry(jstep.index, keys, "flat", options)
            steps.append(tstep)
        return steps[0], steps[1], keys

    monkeypatch.setattr(TWIN, "_make_steps", carried)
    monkeypatch.setattr(tserve, "RequestScheduler", scheduler("torch", tserve.RequestScheduler))
    got = TWIN.serve_drill(0, "cpu", clock=TickingClock())

    assert got == want
    assert len(traces["torch"]) == len(traces["jax"]) == 3
    for t, j in zip(traces["torch"], traces["jax"]):
        assert t == j
    assert _counters(scheds["torch"]) == _counters(jsched)
    assert scheds["torch"]._sleep is tchaos.precise_sleep


@pytest.mark.parametrize("seconds", [0.0005, 0.01])
def test_precise_sleep_ends_at_its_deadline_whatever_the_os_adds(monkeypatch, seconds):
    """On a fake clock whose sleep overshoots by 1 ms: a coarse sleep to
    SPIN_S before the deadline (none for a shorter request), then a spin
    that stops on the first clock read past the deadline."""
    now, slept = [100.0], []

    def sleep(s):
        slept.append(s)
        now[0] += s + 1e-3

    def perf_counter():
        now[0] += 1e-5
        return now[0]

    monkeypatch.setattr(tchaos, "time", types.SimpleNamespace(sleep=sleep,
                                                              perf_counter=perf_counter))
    tchaos.precise_sleep(seconds)
    deadline = 100.0 + 1e-5 + seconds
    assert slept == ([] if seconds <= tchaos.SPIN_S else [seconds - tchaos.SPIN_S])
    assert deadline <= now[0] < deadline + 2e-5
    assert tchaos.FaultPlan([]).sleep is tchaos.precise_sleep
