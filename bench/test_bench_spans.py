"""The readers of the program's own spans (``bench/lib/spans.py``) on
hand-built slices, and the tiny CPU traced runs that read them."""
import types

import pytest

from bench.lib import spans
from bench.lib.profiling import Event, Profile, SpanSlice


def _profile(calls=2):
    """Device busy 0-10, 30-40, 70-95 µs of a 100-µs window, so idle 10-30,
    40-70, 95-100; the host in index.validate 0-5, index.search 5-90,
    ann.query 20-60 inside it, kernel.x 25-35 inside that, and an aten op
    that is none of the program's spans."""
    device = [Event("k", "kernel", 0, 10), Event("k", "kernel", 30, 40),
              Event("k", "kernel", 70, 95)]
    host = [Event("index.validate", "cpu_op", 0, 5), Event("index.search", "cpu_op", 5, 90),
            Event("ann.query", "cpu_op", 20, 60), Event("kernel.x", "cpu_op", 25, 35),
            Event("aten::copy_", "cpu_op", 62, 68)]
    return Profile(device, host, 0.0, 100.0, calls=calls)


def test_idle_ms_inside_named_spans_and_outside_a_prefix():
    p = _profile()
    facade = {"index.validate", "index.search"}
    # (0, 90) less ann.* (20, 60) is (0, 20) and (60, 90): idle 10-20 and 60-70
    assert spans.idle_ms(p, facade, "ann.") == 0.01  # 20 µs over 2 calls
    assert spans.idle_ms(p, facade) == 0.025  # and 20-30, 40-60 in ann.query
    assert spans.idle_ms(p, {"index.search"}, per="index.search") == 0.05
    assert spans.idle_ms(p, {"serve.flush"}) is None  # no such span
    assert spans.idle_ms(_profile(calls=0), facade) is None
    bare = _profile()
    bare.device = []
    assert spans.idle_ms(bare, facade) is None  # no device events: the CPU
    assert spans.idle_ms(None, facade) is None


def test_idle_split_by_the_innermost_span():
    p = _profile()
    names = {"index.validate", "index.search", "ann.query", "kernel.x"}
    assert spans.idle_by_span(p, names) == {
        "index.search": 20.0, "ann.query": 25.0, "kernel.x": 5.0, "": 5.0}
    assert sum(spans.idle_by_span(p, names).values()) == sum(b - a for a, b in p.gaps())
    assert spans.idle_by_span(p, set()) == {"": 55.0}


def test_spans_per_call_counts_a_prefix():
    names = ["index.search", "sync.upload", "sync.ids", "synced", "sync.ids", "index.search"]
    s = SpanSlice([types.SimpleNamespace(name=n) for n in names], 0.0, 1.0, calls=2)
    run = types.SimpleNamespace(spans=s)
    assert spans.spans_per_call(run, "sync.") == 1.5
    assert spans.spans_per_call(run, "serve.") is None  # a program without them
    assert spans.spans_per_call(types.SimpleNamespace(spans=None), "sync.") is None
    s.calls = 0
    assert spans.spans_per_call(run, "sync.") is None


# at the tiny sizes (bench/conftest.py): deep1m's n = 9,000 takes the fused
# pipeline, whose select (T = 880 of 9,000) checks its buffer for overflow:
# the upload, that check and the three copies back; a cp_search reads its
# answer once
@pytest.mark.parametrize("cell,metric,value", [
    ("deep1m.ann_b64", "dispatch.syncs_per_search", 5.0),
    ("audio.cp_mixk", "dispatch.syncs_per_cp", 1.0),
    ("deep1m.serve_open", "serve.submit_ms", None),
])
def test_traced_run_reads_the_programs_own_spans(tiny_run, cell, metric, value):
    result, _ = tiny_run(cell, trace=True)
    assert result["correct"], result["checks"]
    got = result["metrics"][metric]
    if value is None:
        assert 0.0 < got["value"] < 50.0 and got["unit"] == "ms"
    else:
        assert got == {"value": value, "unit": "count"}
    # the device-idle readings of the program's spans need a device profile
    assert not any(k.endswith("idle_ms") or ".idle_ms." in k for k in result["metrics"])


@pytest.mark.parametrize("cell,per_call", [
    ("deep1m.ann_b64", {"index.validate": 1, "index.search": 1, "sync.upload": 1,
                        "sync.select_overflow": 1, "sync.ids": 1, "sync.distances": 1,
                        "sync.counts": 1}),
    ("audio.cp_mixk", {"index.cp_search": 1, "cp.query": 1, "sync.cp_answer": 1}),
    ("deep1m.serve_open", {"serve.submit": 1}),
])
def test_profiled_slice_holds_the_programs_spans_as_ranges(tiny_run, monkeypatch, cell,
                                                           per_call):
    """The harness's profiled slice, run as it is, holds a host range for
    each of the program's spans: tracing is off there and the profiler
    on, so each span site opens one."""
    from bench.lib import cells

    real, held = cells.profile_slice, []

    def keep(fn, device):
        held.append(real(fn, device))
        return held[-1]

    monkeypatch.setattr(cells, "profile_slice", keep)
    result, _ = tiny_run(cell, trace=True)
    assert result["correct"], result["checks"]
    (prof,) = held
    names = [e.name for e in prof.host]
    assert prof.calls > 0
    for name, n in per_call.items():
        assert names.count(name) == n * prof.calls, name
    if cell == "deep1m.serve_open":
        assert 0 < names.count("serve.flush") <= prof.calls
