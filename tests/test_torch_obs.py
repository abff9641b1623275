"""The port's observability (``repro_torch.obs``) held against ``repro.obs``.

Seeded numpy inputs go through both packages on the CPU, where the port's
kernels run their plain PyTorch versions and JAX its jnp oracles:

* the metrics registry: the same operations give the same Prometheus
  text, snapshot and delta, byte for byte;
* the roofline models: equal to the reference's for seeded shapes (the
  refinement arguments the port adds default to the reference's count);
  the peaks keyed on the torch device;
* the span trees of the fused flat, unfused flat, ``flat-pq``,
  ``cp_search`` and streaming paths: names, nesting, every stage attr but
  the select's survivor count (the jnp oracle of radius_select thresholds
  differently, see test_torch_flat.py) and every ``kernel.*`` span's
  bytes and FLOPs equal;
* ``chip_smoke.EXPECTED_SPAN_TREES``: the reference's trees;
* the exporters: the same Chrome trace and stage summary for the same
  spans;
* the quality auditor: the same sample decisions, report fields to rel
  1e-6 on the flat, ``flat-pq``, ``pmtree`` and streaming indexes;
* the drift monitor's gauges.
"""
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.core.hashing import ProjectionFamily as JaxFamily
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro.obs import drift as jdrift
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import quality as jquality
from repro.obs import roofline as jroof
from repro.obs import trace as jtrace
from repro_torch.convert import codec_from_arrays
from repro_torch.core.hashing import ProjectionFamily
from repro_torch.index import FlatBackend, IndexConfig, PMTreeBackend
from repro_torch.obs import drift, export, metrics, quality, roofline, trace
from repro_torch.stream import StreamingIndex

ROOT = pathlib.Path(__file__).resolve().parents[1]
D, K = 16, 10


def _queries(data, B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, data.shape[0], B)
    return (data[ids] + 0.3 * rng.normal(size=(B, data.shape[1]))).astype(np.float32)


# -- metrics ----------------------------------------------------------------


def _metric_ops(mod, script):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(script)
    c = reg.counter("wal_records_total", "records by op", labels=("op",))
    g = reg.gauge("quality_recall", "recall")
    h = reg.histogram("wal_fsync_seconds", "fsync", max_exemplars=3)
    hl = reg.histogram("serve_latency_seconds", "by tier", labels=("tier",),
                       buckets=(0.001, 0.01, 0.1))
    b = reg.counter("bounded_total", "bounded", labels=("id",), max_series=3)
    for i in range(40):
        c.inc(float(rng.integers(1, 4)), op=("insert", "delete", "flush")[i % 3])
        g.set(float(rng.random()))
        v = float(rng.exponential(0.01 * (script + 1)))
        h.observe(v, exemplar={"i": i})
        hl.observe(v, tier=("primary", "degraded")[i % 2])
        b.inc(id=str(i % 5))
    g2 = reg.gauge("trace_dropped_spans", "dropped")
    g2.set_fn(lambda: 7.0)
    return reg


@pytest.mark.parametrize("script", [0, 1, 2])
def test_prometheus_text_snapshot_and_delta_match_the_reference(script):
    jr, tr = _metric_ops(jmetrics, script), _metric_ops(metrics, script)
    assert tr.to_prometheus() == jr.to_prometheus()
    assert tr.snapshot() == jr.snapshot()
    before_j, before_t = jr.snapshot(), tr.snapshot()
    for reg in (jr, tr):
        reg.counter("wal_records_total", labels=("op",)).inc(2.0, op="insert")
        reg.histogram("wal_fsync_seconds").observe(0.5, exemplar={"late": 1})
    assert (tr.delta(tr.snapshot(), before_t) == jr.delta(jr.snapshot(), before_j))
    assert (tr.get("wal_fsync_seconds").slowest(2)
            == jr.get("wal_fsync_seconds").slowest(2))
    assert tr.get("bounded_total").dropped_series == jr.get("bounded_total").dropped_series == 16


def test_registry_rejects_what_the_reference_rejects():
    reg = metrics.MetricsRegistry()
    reg.counter("x_total", labels=("a",))
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        reg.counter("x_total", labels=("a",)).inc(-1.0, a="1")
    assert metrics.get_registry() is metrics.get_registry()
    # the tracer's drop counter, exported on import of obs
    assert metrics.get_registry().get("trace_dropped_spans") is not None


# -- roofline models --------------------------------------------------------


_MODELS = {
    "pairwise_sq_dist_cost": lambda r: (int(r.integers(1, 129)), int(r.integers(1, 10**6)),
                                        int(r.integers(1, 300))),
    "project_dist_cost": lambda r: (int(r.integers(1, 10**6)), int(r.integers(1, 300)),
                                    int(r.integers(1, 33)), int(r.integers(1, 129))),
    "adc_dist_cost": lambda r: (int(r.integers(1, 129)), int(r.integers(1, 10**5)),
                                int(r.integers(1, 33)), 256),
    "topk_cost": lambda r: (int(r.integers(1, 129)), int(r.integers(1, 10**5)),
                            int(r.integers(1, 129))),
    "radius_select_cost": lambda r: (int(r.integers(1, 129)), int(r.integers(1, 10**6)),
                                     int(r.integers(1, 10**5))),
    "verify_topk_cost": lambda r: (int(r.integers(1, 129)), int(r.integers(1, 10**5)),
                                   int(r.integers(1, 300)), int(r.integers(1, 129))),
    "pair_join_cost": lambda r: (int(r.integers(2, 60_000)), int(r.integers(1, 300)),
                                 int(r.integers(1, 129))),
}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_cost_models_equal_the_reference(model):
    rng = np.random.default_rng(len(model))
    for _ in range(5):
        args = _MODELS[model](rng)
        want = getattr(jroof, model)(*args)
        got = getattr(roofline, model)(*args)
        assert (got.bytes, got.flops, got.attrs()) == (want.bytes, want.flops, want.attrs())
        peaks = jroof.DevicePeaks("x", 6.7e13, 3.35e12)
        t = float(rng.uniform(1e-5, 1e-2))
        assert roofline.achieved(got, t, roofline.DevicePeaks("x", 6.7e13, 3.35e12)) == \
            jroof.achieved(want, t, peaks)


def test_refined_models_take_the_realized_work():
    """The port's extra arguments default to the reference's a-priori
    count; given, they replace it as pair_join's tiles_visited does."""
    assert roofline.verify_topk_cost(64, 1000, 256, 10, rows_read=64 * 1000) == \
        roofline.verify_topk_cost(64, 1000, 256, 10)
    few = roofline.verify_topk_cost(64, 1000, 256, 10, rows_read=1000)
    assert few.bytes == (1000 * 256 + 64 * 256 + 4 * 64 * 10) * 4
    assert few.flops == roofline.verify_topk_cost(64, 1000, 256, 10).flops
    four = roofline.radius_select_cost(64, 10**6, 108_792, passes=4)
    want = jroof.radius_select_cost(64, 10**6, 108_792, passes=4)
    assert (four.bytes, four.flops) == (want.bytes, want.flops)
    join = roofline.pair_join_cost(54_387, 192, 10, tiles_visited=5)
    want = jroof.pair_join_cost(54_387, 192, 10, tiles_visited=5)
    assert (join.bytes, join.flops) == (want.bytes, want.flops)


def test_peaks_keyed_on_the_torch_device():
    cuda = roofline.get_peaks("cuda")
    assert (cuda.kind, cuda.peak_bw, cuda.peak_flops) == ("cuda", 3.35e12, 6.7e13)
    assert cuda.name == "NVIDIA H100 80GB HBM3" and cuda.ridge == pytest.approx(20.0)
    cpu = roofline.get_peaks("cpu")
    assert (cpu.peak_flops, cpu.peak_bw) == (3.2e11, 4.0e10)
    assert roofline.get_peaks("tpu") == cpu  # no TPU or A100 entry
    assert roofline.device_kind("cpu") == "cpu"
    assert roofline.device_kind(torch.device("cuda", 0)) == "cuda"
    assert roofline.device_kind() == ("cuda" if torch.cuda.is_available() else "cpu")
    pinned = roofline.DevicePeaks("cuda", 1e13, 1e12)
    roofline.set_peaks(pinned)
    try:
        assert roofline.get_peaks("cpu") is pinned
    finally:
        roofline.set_peaks(None)
    assert roofline.get_peaks("cuda") == cuda


def test_chip_smoke_reads_its_peaks_from_the_roofline():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "roofline.get_peaks(\"cuda\")" in src
    assert "3.35e12" not in src and "67e12" not in src
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cuda = roofline.get_peaks("cuda")
    assert (chip_smoke.PEAK_BYTES_PER_S, chip_smoke.PEAK_F32_PER_S) == (cuda.peak_bw,
                                                                       cuda.peak_flops)


# -- span trees against the reference ---------------------------------------


_STAGE_ATTRS_SKIPPED = ("candidates_selected", "work")


def _tree(spans):
    """(name, parent, attrs) per span; the select's survivor count and
    the WorkStats that carry it are left out (see the module docstring)."""
    return [(s.name, s.parent,
             {k: v for k, v in s.attrs.items() if k not in _STAGE_ATTRS_SKIPPED})
            for s in spans]


_FLAT = {}


def _flat_pair(n, quant):
    key = (n, quant)
    if key not in _FLAT:
        data = make_clustered(n, D, seed=n + quant)
        opts = {"quant": "pq", "pq": {"m_codebooks": 4}} if quant else {}
        ji = jax_build_index(data, JaxConfig(backend="flat", options={"force": "ref", **opts}))
        kw = {}
        if quant:
            kw = dict(codec=codec_from_arrays(centroids=np.asarray(ji.codec.centroids),
                                              d=D, device="cpu"),
                      codes=np.asarray(ji.codes))
        ti = FlatBackend.from_arrays(data, np.asarray(ji.impl.family.a),
                                     np.asarray(ji.impl.projected),
                                     IndexConfig(backend="flat", options=opts),
                                     device="cpu", **kw)
        _FLAT[key] = data, ji, ti
    return _FLAT[key]


@pytest.mark.parametrize("n,quant,call", [
    (8192, False, "search"),   # fused flat
    (2000, False, "search"),   # unfused flat: one ann.query span
    (8192, True, "search"),    # flat-pq, fused, R > 128
    (2000, True, "search"),    # flat-pq, unfused
    (2000, False, "cp"),       # cp_search
    (2000, True, "cp"),        # flat-pq cp_search (R > 128: the plain join)
])
def test_span_tree_and_kernel_models_match_jax(n, quant, call):
    data, ji, ti = _flat_pair(n, quant)
    q = _queries(data, 5, seed=n + 1)
    run = (lambda index: index.search(q, K)) if call == "search" else (
        lambda index: index.cp_search(K))
    with jtrace.trace() as jtr:
        rj = run(ji)
    with trace.trace() as ttr:
        rt = run(ti)
    assert _tree(ttr.spans) == _tree(jtr.spans)
    kernels = [s for s in ttr.spans if s.name.startswith("kernel.")]
    assert all(s.attrs["bytes"] > 0 and s.attrs["flops"] > 0 for s in kernels)
    # the unfused float pipeline is one span, as the reference's one jit call
    assert bool(kernels) == (quant or call == "cp" or n >= 8192)
    if call == "search":
        np.testing.assert_array_equal(rt.indices, rj.indices)
        untraced = ti.search(q, K)  # tracing changes no answer
        np.testing.assert_array_equal(untraced.indices, rt.indices)
        np.testing.assert_array_equal(untraced.distances, rt.distances)
        assert untraced.stats == rt.stats
    else:
        np.testing.assert_array_equal(rt.pairs, rj.pairs)
    assert not trace.enabled()


def test_streaming_span_tree_matches_jax_with_a_fused_segment():
    """A streaming index with a sealed 8,192-row flat segment (the fused
    pipeline's ann.* spans), a delta and tombstones: the whole tree equal."""
    from repro.stream.segment import Segment as JaxSegment
    from repro_torch.stream.segment import Segment

    # segment serials (a span attr) come from process-wide counters: start
    # both from one value, whatever the tests run before in this process
    JaxSegment._serial = Segment._serial = max(JaxSegment._serial, Segment._serial)
    data = make_clustered(8192, D, seed=3)
    opts = {"segment_backend": "flat", "delta_threshold": 4096, "max_segments": 4}
    a = np.asarray(JaxFamily.create(D, 15, seed=0).a)
    ji = jax_build_index(data, JaxConfig(backend="streaming", options=opts))
    ti = StreamingIndex.from_arrays(data, a, IndexConfig(backend="streaming", options=opts),
                                    device="cpu")
    extra = make_clustered(300, D, seed=4)
    for index in (ji, ti):
        index.insert(extra)
        index.delete(np.arange(0, 40, 3))
    q = _queries(data, 4, seed=5)
    with jtrace.trace() as jtr:
        rj = ji.search(q, K)
    with trace.trace() as ttr:
        rt = ti.search(q, K)
    assert _tree(ttr.spans) == _tree(jtr.spans)
    assert "ann.verify" in [s.name for s in ttr.spans]
    np.testing.assert_array_equal(rt.indices, rj.indices)
    with jtrace.trace() as jtr:
        ji.cp_search(5)
    with trace.trace() as ttr:
        ti.cp_search(5)
    assert _tree(ttr.spans) == _tree(jtr.spans)


def test_chip_smoke_expected_trees_are_the_reference_trees():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    data, ji, _ = _flat_pair(8192, False)
    _, jpq, _ = _flat_pair(8192, True)
    q = _queries(data, 64, seed=9)
    got = {}
    for name, run in (("fused", lambda: ji.search(q, K)), ("flat-pq", lambda: jpq.search(q, K)),
                      ("cp", lambda: ji.cp_search(K))):
        with jtrace.trace() as jtr:
            run()
        got[name] = [(s.name, s.parent) for s in jtr.spans]
    assert chip_smoke.EXPECTED_SPAN_TREES == got
    for name, tree in got.items():
        kernels = [n for n, _ in tree if n.startswith("kernel.")]
        assert len(chip_smoke.KERNEL_LINE_SHAPES[name]) == len(kernels)


def test_kernel_span_attrs_and_refinement_hooks():
    """A kernel span closes around its op and carries the model; the
    trace helpers the refinement uses: current_span and paused."""
    from repro_torch.kernels import ops

    d2 = torch.rand(3, 500)
    with trace.trace() as tr:
        ops.radius_select(d2, 40, with_count=True)
        with trace.span("outer") as sp:
            assert trace.current_span() is sp
            with trace.paused():
                assert trace.current_span() is None
                ops.topk_smallest(d2, 5)
    assert [s.name for s in tr.spans] == ["kernel.radius_select", "outer"]
    want = jroof.radius_select_cost(3, 500, 40 + 256).attrs()
    assert {k: tr.spans[0].attrs[k] for k in want} == want
    assert trace.current_span() is None


# -- exporters --------------------------------------------------------------


def _spans(mod):
    S = mod.Span
    return [S("index.search", 1.0, 1.010, -1, {"B": 4}),
            S("ann.query", 1.0005, 1.0098, 0, {}),
            S("kernel.pairwise_sq_dist", 1.001, 1.003, 1,
              jroof.pairwise_sq_dist_cost(4, 10**5, 15).attrs()),
            S("kernel.verify_topk", 1.004, 1.009, 1,
              {**jroof.verify_topk_cost(4, 900, 64, 10).attrs(), "tag": np.float32(1.5)}),
            S("index.cp_search", 2.0, 2.0, -1, {"x": float("inf")})]


def test_exports_equal_the_reference_for_the_same_spans():
    peaks_j = jroof.DevicePeaks("cuda", 6.7e13, 3.35e12)
    peaks_t = roofline.DevicePeaks("cuda", 6.7e13, 3.35e12)
    jt = jexport.to_chrome_trace(_spans(jtrace), peaks=peaks_j, process_name="p")
    tt = export.to_chrome_trace(_spans(trace), peaks=peaks_t, process_name="p")
    assert tt == jt
    export.validate_chrome_trace(tt)
    assert export.coverage(_spans(trace)) == jexport.coverage(_spans(jtrace))
    assert export.stage_summary(_spans(trace), peaks=peaks_t) == \
        jexport.stage_summary(_spans(jtrace), peaks=peaks_j)
    with pytest.raises(ValueError):
        export.validate_chrome_trace({"traceEvents": [{"name": 1, "ph": "X"}]})


def test_save_chrome_trace_of_a_traced_search(tmp_path):
    data, _, ti = _flat_pair(2000, False)
    with trace.trace() as tr:
        ti.search(_queries(data, 3, seed=11), K)
    path = export.save_chrome_trace(str(tmp_path / "t.json"), tr)
    import json

    obj = json.loads(pathlib.Path(path).read_text())
    export.validate_chrome_trace(obj)
    assert [e["name"] for e in obj["traceEvents"][1:]] == [s.name for s in tr.spans]
    assert 0.0 < export.coverage(tr) <= 1.0


# -- quality auditor --------------------------------------------------------


@pytest.mark.parametrize("fraction,seed", [(0.0, 0), (0.3, 0), (0.3, 7), (1.0, 3)])
def test_sample_decisions_equal_the_reference(fraction, seed):
    rng = np.random.default_rng(int(fraction * 10) + seed)
    for _ in range(200):
        qb = rng.normal(size=D).astype(np.float32).tobytes()
        assert quality.sample_decision(qb, fraction, seed) == \
            jquality.sample_decision(qb, fraction, seed)


def test_ci_coverage_equals_the_reference():
    rng = np.random.default_rng(12)
    r = rng.exponential(size=500)
    r[:7] = 0.0
    rp = r * np.sqrt(rng.chisquare(15, size=500))
    for alpha in (0.05, 1 / math.e):
        assert quality.ci_coverage(r, rp, 15, alpha) == jquality.ci_coverage(r, rp, 15, alpha)


def _pmtree_pair(data):
    ji = jax_build_index(data, JaxConfig(backend="pmtree", c=1.5))
    ti = PMTreeBackend.from_arrays(data, np.asarray(ji.impl.family.a),
                                   np.asarray(ji.impl.projected),
                                   IndexConfig(backend="pmtree", c=1.5), device="cpu")
    return ji, ti


def _stream_pair(data):
    opts = {"segment_backend": "flat", "delta_threshold": 512}
    ji = jax_build_index(data, JaxConfig(backend="streaming", options=opts))
    ti = StreamingIndex.from_arrays(data, np.asarray(JaxFamily.create(D, 15, seed=0).a),
                                    IndexConfig(backend="streaming", options=opts),
                                    device="cpu")
    for index in (ji, ti):
        index.insert(make_clustered(200, D, seed=21))
        index.delete(np.arange(0, 60, 2))
    return ji, ti


@pytest.mark.parametrize("backend", ["flat", "flat-pq", "pmtree", "streaming"])
def test_quality_report_equals_the_reference(backend):
    if backend in ("flat", "flat-pq"):
        data, ji, ti = _flat_pair(2000, backend == "flat-pq")
    else:
        data = make_clustered(1500, D, seed=20)
        ji, ti = (_pmtree_pair if backend == "pmtree" else _stream_pair)(data)
    q = _queries(data, 24, seed=22)
    jreg, treg = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    ja = jquality.QualityAuditor.for_index(ji, sample_fraction=0.6, seed=4, registry=jreg)
    ta = quality.QualityAuditor.for_index(ti, sample_fraction=0.6, seed=4, registry=treg)
    assert ta.device == torch.device("cpu")
    rj, rt = ji.search(q, K), ti.search(q, K)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    for i in range(len(q)):
        assert ta.maybe_sample(q[i], rt.indices[i], rt.distances[i]) == \
            ja.maybe_sample(q[i], rj.indices[i], rj.distances[i])
    assert ta.sampled == ja.sampled > 0
    assert ta.audit(max_items=5) == ja.audit(max_items=5) == 5
    assert ta.audit() == ja.audit()
    jrep, trep = ja.report(), ta.report()
    for field in ("sampled", "audited", "pending", "coverage_pairs"):
        assert getattr(trep, field) == getattr(jrep, field)
    assert trep.audited == trep.sampled - trep.pending
    for field in ("recall", "ratio", "ci_coverage", "nominal_coverage", "alpha"):
        assert getattr(trep, field) == pytest.approx(getattr(jrep, field), rel=1e-6)
    assert trep.calibration_error == pytest.approx(jrep.calibration_error, rel=1e-6, abs=1e-9)
    assert treg.to_prometheus() == jreg.to_prometheus()


def test_auditor_queue_bound_and_host_rows_move_once_per_audit():
    moved = []
    rows = make_clustered(300, D, seed=23)

    def get_rows():
        moved.append(1)
        return np.arange(300), rows

    reg = metrics.MetricsRegistry()
    aud = quality.QualityAuditor(get_rows, sample_fraction=1.0, max_pending=4,
                                 registry=reg, device="cpu")
    for i in range(6):
        aud.maybe_sample(rows[i], np.arange(i, i + 5), np.zeros(5, np.float32))
    assert (aud.sampled, aud.overflowed, aud.pending) == (4, 2, 4)
    assert aud.audit() == 4 and len(moved) == 1
    assert aud.report().recall == pytest.approx(0.2)  # each answer holds itself
    assert reg.get("quality_audited_total").get() == 4.0


# -- drift gauges -----------------------------------------------------------


def test_drift_gauges_equal_the_reference():
    a = np.asarray(JaxFamily.create(D, 15, seed=1).a)
    jreg, treg = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    jm = jdrift.DriftMonitor(JaxFamily(a=a), baseline_rows=64, registry=jreg)
    tm = drift.DriftMonitor(ProjectionFamily.from_numpy(a, "cpu"), baseline_rows=64,
                            registry=treg)
    names = ("drift_mean_shift", "drift_var_ratio", "drift_occupancy_tv", "drift_recalibrate")
    assert [treg.get(n).get() for n in names] == [0.0] * 4
    rng = np.random.default_rng(24)
    for step in range(6):
        rows = (rng.normal(size=(40, D)) * (1.0 + 0.6 * step) + step).astype(np.float32)
        counts = rng.integers(0, 100, 16)
        for mon in (jm, tm):
            mon.observe_rows(rows)
            mon.observe_survivors(counts if step < 3 else counts // 4, 100)
    jrep, trep = jm.report(), tm.report()
    assert trep.recalibrate == jrep.recalibrate is True
    for n in names:
        assert treg.get(n).get() == pytest.approx(jreg.get(n).get(), rel=1e-5)
    assert treg.get("drift_recalibrate").get() == 1.0
