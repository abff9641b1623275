"""The port's streaming index held against the JAX streaming index.

Both indexes take the same operations on the same ``make_clustered``
data (d = 32, 2,000 seed rows, ``delta_threshold`` 256, ``max_segments``
4): ``repro.stream.StreamingIndex`` with ``segment_backend="flat"`` (or
``"flat-pq"``, or the default ``"pmtree"`` where a test says so), and the
port's ``StreamingIndex.from_arrays`` given the JAX family's A, on
``device="cpu"``, where every kernel runs its plain PyTorch version.  The JAX side runs its jnp oracles (``force="ref"``, the
CPU default) unless a test says otherwise.

After every step: ids identical; distances to rtol 1e-5 (segments answer
in the difference form on both sides, the delta scan in the norm trick
with the cross term summed by another BLAS than XLA's); segment count,
delta size, flushes, compactions, tombstones per segment, ``live_ids()``
and the ``WorkStats`` sums identical.
"""
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.core.hashing import ProjectionFamily as JaxFamily
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro.resilience import chaos as jax_chaos
from repro_torch.index import (
    FlatBackend,
    IndexConfig,
    MutableIndex,
    available_backends,
    backend_capabilities,
    build_index,
)
from repro_torch.kernels import counts
from repro_torch.obs import trace
from repro_torch.resilience import chaos
from repro_torch.stream import StreamingIndex

D, K = 32, 10
OPTS = {"segment_backend": "flat", "delta_threshold": 256, "max_segments": 4}


def _a(d=D, m=15, seed=0):
    return np.asarray(JaxFamily.create(d, m, seed=seed).a)


def _pair(data, options=None, jax_options=None):
    """(JAX streaming index, the port's on the CPU) over ``data``."""
    opts = {**OPTS, **(options or {})}
    ji = jax_build_index(data, JaxConfig(backend="streaming",
                                         options={**opts, **(jax_options or {})}))
    ti = StreamingIndex.from_arrays(data, _a(data.shape[1]),
                                    IndexConfig(backend="streaming", options=opts),
                                    device="cpu")
    return ji, ti


def _queries(data, B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, data.shape[0], B)
    return (data[ids] + 0.3 * rng.normal(size=(B, data.shape[1]))).astype(np.float32)


def _same_state(ji, ti):
    assert (ti.segment_count, ti.delta_size, ti.n_flushes, ti.n_compactions, ti.n) == (
        ji.segment_count, ji.delta_size, ji.n_flushes, ji.n_compactions, ji.n)
    assert [(s.size, s.dead) for s in ti.segments] == [(s.size, s.dead) for s in ji.segments]
    np.testing.assert_array_equal(ti.live_ids(), ji.live_ids())
    assert ti.total_assigned == ji.total_assigned


def _same_search(ji, ti, q, k=K):
    rj, rt = ji.search(q, k), ti.search(q, k)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32
    return rt


def _steps():
    """A mixed insert / delete / flush sequence: (name, fn(index, live)),
    each fn a function of the live ids before the step."""
    batches = [make_clustered(n, D, seed=100 + i) for i, n in enumerate((100, 180, 70, 300, 40))]

    def kill(idx, live, n, newest=False):
        pool = live[-400:] if newest else live
        rng = np.random.default_rng(len(live) + n)
        return idx.delete(rng.choice(pool, n, replace=False))

    return [
        ("insert 100", lambda idx, live: idx.insert(batches[0])),      # stays in the delta
        ("delete in delta", lambda idx, live: idx.delete(live[-30:])),
        ("insert 180", lambda idx, live: idx.insert(batches[1])),      # 250 < 256
        ("delete sealed", lambda idx, live: kill(idx, live, 25)),
        ("insert 70 (flush)", lambda idx, live: idx.insert(batches[2])),
        ("flush (empty)", lambda idx, live: idx.flush()),
        ("insert 300 (flush)", lambda idx, live: idx.insert(batches[3])),
        ("delete newest", lambda idx, live: kill(idx, live, 60, newest=True)),
        ("insert 40", lambda idx, live: idx.insert(batches[4])),
        ("flush (compaction)", lambda idx, live: idx.flush()),
        ("delete mixed", lambda idx, live: kill(idx, live, 50)),
    ]


@pytest.mark.parametrize("backend,options", [
    ("flat", {}),
    ("flat-pq", {"quant": "pq", "pq": {"m_codebooks": 8}}),
])
def test_mixed_sequence_matches_jax(backend, options):
    data = make_clustered(2000, D, seed=0)
    ji, ti = _pair(data, {"segment_backend": backend, **options})
    q = _queries(data, 7, seed=1)
    _same_state(ji, ti)
    _same_search(ji, ti, q)
    for i, (name, step) in enumerate(_steps()):
        live = ji.live_ids()
        np.testing.assert_array_equal(step(ti, live), step(ji, live), err_msg=name)
        _same_state(ji, ti)
        _same_search(ji, ti, q, k=1 + 3 * i)
    assert ti.n_flushes >= 3 and ti.n_compactions >= 1 and ti.delta_size == 0
    rj, rt = ji.cp_search(K), ti.cp_search(K)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-6)
    assert rt.stats.as_dict() == rj.stats.as_dict()


def test_default_pmtree_segments_match_jax():
    """The reference's default: pmtree segments.  Each side projects a
    segment's rows itself (the port sums in float64 and rounds once, XLA
    in float32), so the trees may differ in the last bit of a coordinate
    and with them the work counters; the ids must be identical after
    every step of inserts, deletes, flushes and a compaction."""
    data = make_clustered(1500, D, seed=40)
    opts = {"delta_threshold": 256, "max_segments": 4}
    ji = jax_build_index(data, JaxConfig(backend="streaming", options=opts))
    ti = StreamingIndex.from_arrays(data, _a(), IndexConfig(backend="streaming",
                                                            options=opts), device="cpu")
    assert ti.segment_backend == ji.segment_backend == "pmtree"
    assert all(type(s.index).__name__ == "PMTreeBackend" for s in ti.segments)
    q = _queries(data, 5, seed=41)
    for i, (name, step) in enumerate(_steps()):
        live = ji.live_ids()
        np.testing.assert_array_equal(step(ti, live), step(ji, live), err_msg=name)
        _same_state(ji, ti)
        rj, rt = ji.search(q, 1 + 3 * i), ti.search(q, 1 + 3 * i)
        np.testing.assert_array_equal(rt.indices, rj.indices, err_msg=name)
        np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5, err_msg=name)
        assert rt.stats.rounds > 0 and rt.stats.node_distance_computations > 0
    assert ti.n_flushes >= 3 and ti.n_compactions >= 1
    rj, rt = ji.cp_search(K), ti.cp_search(K)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    assert rt.stats.as_dict() == rj.stats.as_dict()


def test_from_arrays_seals_pmtree_segments_with_the_given_a():
    """A pmtree segment is a PMTreeBackend over its rows with the index's
    A: one sealed segment answers what that backend answers, work
    counters included."""
    from repro_torch.index import PMTreeBackend

    data = make_clustered(900, D, seed=42)
    a = _a(seed=5)
    ti = StreamingIndex.from_arrays(data, a, IndexConfig(
        backend="streaming", options={"segment_backend": "pmtree"}), device="cpu")
    seg = ti.segments[0].index
    assert ti.segment_count == 1 and ti.delta_size == 0
    assert isinstance(seg, PMTreeBackend) and isinstance(seg.data, np.ndarray)
    np.testing.assert_array_equal(seg.a, a)
    alone = PMTreeBackend.from_arrays(data, a, None, IndexConfig(backend="pmtree"),
                                      device="cpu")
    np.testing.assert_array_equal(seg.projected, alone.projected)
    q = _queries(data, 4, seed=43)
    rs, ra = ti.search(q, K), alone.search(q, K)
    np.testing.assert_array_equal(rs.indices, ra.indices)
    np.testing.assert_array_equal(rs.distances, ra.distances)
    assert rs.stats.as_dict() == ra.stats.as_dict()


@pytest.mark.parametrize("B", [1, 7])
def test_tombstones_never_returned(B):
    data = make_clustered(2000, D, seed=3)
    ji, ti = _pair(data)
    q = _queries(data, B, seed=4)
    near = ti.search(q, K).indices.reshape(-1)
    assert ti.delete(near) == ji.delete(near) > 0
    _same_state(ji, ti)
    rt = _same_search(ji, ti, q)
    assert not set(near.tolist()) & set(rt.indices.reshape(-1).tolist())


@pytest.mark.parametrize("where", ["delta", "sealed"])
def test_delete_is_physical_in_delta_tombstone_when_sealed(where):
    data = make_clustered(2000, D, seed=5)
    ji, ti = _pair(data)
    # near the origin, far from the clusters, and |probe|² ≈ 0: the delta
    # scan's norm trick does not cancel, so both sides rank alike
    probe = np.zeros((1, D), np.float32)
    rows = probe + np.linspace(0.5, 1.0, 8)[:, None].astype(np.float32)
    new = ti.insert(rows)
    np.testing.assert_array_equal(ji.insert(rows), new)
    if where == "sealed":
        ti.flush()
        ji.flush()
    before = ti.delta_size
    assert ti.delete(new[:1]) == ji.delete(new[:1]) == 1
    _same_state(ji, ti)
    if where == "delta":
        assert ti.delta_size == before - 1 and sum(s.dead for s in ti.segments) == 0
    else:
        assert ti.delta_size == 0 and sum(s.dead for s in ti.segments) == 1
    rt = _same_search(ji, ti, probe, k=5)
    assert new[0] not in rt.indices


def test_insert_visible_before_flush():
    data = make_clustered(2000, D, seed=6)
    ji, ti = _pair(data)
    probe = np.full((1, D), 23.0, np.float32)
    new = ti.insert(probe)
    ji.insert(probe)
    assert ti.delta_size == 1
    rt = _same_search(ji, ti, probe, k=1)
    assert rt.indices[0, 0] == new[0]


@pytest.mark.parametrize("trigger", ["count", "rot"])
def test_compaction_matches_jax(trigger):
    rng = np.random.default_rng(7)
    if trigger == "count":
        opts = {"delta_threshold": 32, "max_segments": 3}
        ji, ti = _pair(np.empty((0, 8), np.float32), opts)
        for _ in range(12):
            x = rng.normal(size=(32, 8)).astype(np.float32)
            ji.insert(x)
            ti.insert(x)
        assert ti.n_compactions >= 1 and ti.segment_count <= 3 and ti.n == 12 * 32
    else:
        opts = {"delta_threshold": 64}
        ji, ti = _pair(rng.normal(size=(200, 8)).astype(np.float32), opts)
        ti.delete(np.arange(150))
        ji.delete(np.arange(150))
        assert ti.n_compactions >= 1 and sum(s.dead for s in ti.segments) == 0
        assert sum(s.size for s in ti.segments) == ti.n == 50
    _same_state(ji, ti)
    _same_search(ji, ti, rng.normal(size=(5, 8)).astype(np.float32), k=4)


def test_empty_build_then_grow():
    ji, ti = _pair(np.empty((0, 8), np.float32))
    assert ti.n == 0
    res = _same_search(ji, ti, np.zeros((2, 8), np.float32), k=4)
    assert (res.indices == -1).all() and np.isinf(res.distances).all()
    x = np.random.default_rng(8).normal(size=(300, 8)).astype(np.float32)
    ji.insert(x)
    ti.insert(x)
    _same_state(ji, ti)
    _same_search(ji, ti, x[:3] + 0.01, k=2)


def test_k_larger_than_live_pads():
    ji, ti = _pair(np.eye(4, dtype=np.float32))
    ji.delete([0])
    ti.delete([0])
    res = _same_search(ji, ti, np.zeros((1, 4), np.float32), k=5)
    assert (res.indices[0, :3] >= 0).all() and (res.indices[0, 3:] == -1).all()
    assert np.isinf(res.distances[0, 3:]).all()


def test_failed_seal_leaves_every_row_served():
    data = make_clustered(50, D, seed=9)  # < delta_threshold: stays buffered
    ti = StreamingIndex.from_arrays(data, _a(), IndexConfig(
        backend="streaming", options={**OPTS, "segment_backend": "no_such"}), device="cpu")
    with pytest.raises(KeyError, match="unknown index backend"):
        ti.flush()
    assert ti.n == 50 and ti.delta_size == 50 and ti.segment_count == 0
    res = ti.search(data[:2] + 0.001, 1)
    assert (res.indices[:, 0] == [0, 1]).all()


def test_non_flat_segment_backend_fails_the_seal():
    data = make_clustered(50, D, seed=9)
    ti = StreamingIndex.from_arrays(data, _a(), IndexConfig(
        backend="streaming", options={**OPTS, "segment_backend": "streaming"}),
        device="cpu")
    with pytest.raises(ValueError, match="not flat-family"):
        ti.flush()
    assert ti.n == 50 and ti.delta_size == 50 and ti.segment_count == 0


def test_error_after_the_seal_keeps_rows_in_the_delta():
    """A crash between building the segment (which took a view of the
    delta's rows) and the drain leaves the rows in the delta, served."""
    data = make_clustered(2000, D, seed=31)
    ji, ti = _pair(data)
    x = make_clustered(300, D, seed=32)  # crosses the threshold
    spec = dict(site="stream.apply", kind="error", at=1)  # the flush's
    with jax_chaos.active(jax_chaos.FaultPlan([jax_chaos.FaultSpec(**spec)])):
        with pytest.raises(jax_chaos.ChaosError):
            ji.insert(x)
    with chaos.active(chaos.FaultPlan([chaos.FaultSpec(**spec)])):
        with pytest.raises(chaos.ChaosError, match="stream.apply"):
            ti.insert(x)
    assert ti.delta_size == 300 and ti.segment_count == 1
    np.testing.assert_array_equal(ti.delta.vectors.numpy(), x)
    _same_state(ji, ti)
    _same_search(ji, ti, _queries(data, 5, seed=33))
    ji.flush()
    ti.flush()
    _same_state(ji, ti)


@pytest.mark.parametrize("kind", ["error", "drop"])
@pytest.mark.parametrize("at", [0, 2])
def test_fault_schedule_matches_jax(kind, at):
    """The port's plan fires on the same accesses as the reference's."""
    def run(mod):
        plan = mod.FaultPlan([mod.FaultSpec("s", kind, at=at),
                              mod.FaultSpec("t", kind, at=0)])
        fired = []
        with mod.active(plan):
            for site in ("s", "t", "s", "s", "s", "t"):
                if kind == "drop":
                    fired.append(mod.dropped(site))
                else:
                    try:
                        mod.hit(site)
                        fired.append(False)
                    except mod.ChaosError:
                        fired.append(True)
        return fired, plan.fired()

    assert run(chaos) == run(jax_chaos)
    assert not chaos.dropped("s")  # no plan installed
    with pytest.raises(ValueError, match="unknown fault kind"):
        chaos.FaultSpec("s", "explode", at=0)
    chaos.FaultSpec("s", "latency", at=0)  # the reference's kinds, all of them


def test_lost_flush_keeps_rows_in_the_delta():
    data = make_clustered(2000, D, seed=10)
    ji, ti = _pair(data)
    x = make_clustered(300, D, seed=11)  # crosses the threshold
    spec = [dict(site="stream.flush", kind="drop", at=0)]
    with jax_chaos.active(jax_chaos.FaultPlan([jax_chaos.FaultSpec(**s) for s in spec])):
        ji.insert(x)
    with chaos.active(chaos.FaultPlan([chaos.FaultSpec(**s) for s in spec])) as plan:
        ti.insert(x)
    assert plan.fired() == {("stream.flush", "drop"): 1}
    assert ti.delta_size == 300
    _same_state(ji, ti)
    _same_search(ji, ti, _queries(data, 5, seed=12))
    ti.flush()
    ji.flush()
    _same_state(ji, ti)
    assert ti.delta_size == 0


def test_error_at_apply_changes_nothing():
    data = make_clustered(500, D, seed=13)
    _, ti = _pair(data)
    before = (ti.n, ti.delta_size, ti.total_assigned)
    plan = chaos.FaultPlan([chaos.FaultSpec("stream.apply", "error", at=0)])
    with chaos.active(plan), pytest.raises(chaos.ChaosError, match="stream.apply"):
        ti.insert(np.ones((3, D), np.float32))
    assert (ti.n, ti.delta_size, ti.total_assigned) == before


@pytest.mark.parametrize("k", [1, 10])
def test_cp_search_over_live_rows_matches_jax(k):
    data = make_clustered(1500, D, seed=14)
    ji, ti = _pair(data)
    x = make_clustered(200, D, seed=15)
    ji.insert(x)
    ti.insert(x)
    kill = ti.cp_search(3).pairs.reshape(-1)  # the closest pairs die
    ji.delete(kill)
    ti.delete(kill)
    _same_state(ji, ti)
    rj, rt = ji.cp_search(k), ti.cp_search(k)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-6)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    assert not set(kill.tolist()) & set(rt.pairs.reshape(-1).tolist())


def test_cp_search_one_hot_rows():
    ti = build_index(2.0 * np.eye(4, dtype=np.float32),
                     IndexConfig(backend="streaming", options=OPTS), device="cpu")
    res = ti.cp_search(2)
    assert res.pairs.shape == (2, 2)
    np.testing.assert_allclose(res.distances, 2.0 * np.sqrt(2.0), rtol=1e-5)
    assert ti.cp_search(100).pairs.shape == (6, 2)


def test_drift_report_matches_jax():
    """Fused segments report survivor counts and their budget T: the
    drift monitor's occupancy signal, which it ignores without the
    budget.  The JAX side runs the Pallas select in interpret mode,
    whose counts the plain version repeats."""
    data = make_clustered(1500, D, seed=16)
    fused = {"fused": True, "drift_baseline": 8}
    ji, ti = _pair(data, fused, {"force": "interpret"})
    rng = np.random.default_rng(17)
    for step in range(3):
        x = (make_clustered(120, D, seed=18 + step) * (1.0 + 0.5 * step)).astype(np.float32)
        ji.insert(x)
        ti.insert(x)
        q = _queries(data, 9, seed=30 + step)
        _same_search(ji, ti, q)
        kill = rng.choice(ji.live_ids(), 20, replace=False)
        assert ti.delete(kill) == ji.delete(kill) == 20
    seg_j, seg_t = ji.segments[0].index, ti.segments[0].index
    assert seg_t.last_select_budget == seg_j.last_select_budget > 0
    np.testing.assert_array_equal(seg_t.last_select_counts, seg_j.last_select_counts)
    np.testing.assert_array_equal(ti.drift._occ_base, ji.drift._occ_base)
    np.testing.assert_array_equal(ti.drift._occ_live, ji.drift._occ_live)
    assert ti.drift._occ_live_n == ji.drift._occ_live_n > 0
    rep_j, rep_t = ji.drift_report(), ti.drift_report()
    for field in ("baseline_rows", "live_rows", "recalibrate"):
        assert getattr(rep_t, field) == getattr(rep_j, field)
    for field in ("mean_shift", "var_ratio", "occupancy_tv"):
        assert getattr(rep_t, field) == pytest.approx(getattr(rep_j, field), rel=1e-6)


def test_quant_rejects_a_segment_backend_that_ignores_it():
    with pytest.raises(ValueError, match="cannot honor"):
        build_index(np.zeros((4, 8), np.float32), IndexConfig(
            backend="streaming", options={"quant": "pq", "segment_backend": "no_such"}),
            device="cpu")


def test_registered_with_stream_capabilities():
    assert "streaming" in available_backends()
    assert available_backends("stream") == ["streaming"]
    assert backend_capabilities("streaming") == frozenset({"ann", "stream", "cp"})
    ti = build_index(np.zeros((3, 8), np.float32),
                     IndexConfig(backend="streaming", options=OPTS), device="cpu")
    assert isinstance(ti, MutableIndex)


def test_own_projection_answers_as_a_flat_index():
    """Without from_arrays the index draws A as the port's flat backend
    does: one sealed segment answers what a flat index over its rows
    answers."""
    data = make_clustered(1200, D, seed=20)
    ti = build_index(data, IndexConfig(backend="streaming", seed=3, options=OPTS),
                     device="cpu")
    flat = build_index(data, IndexConfig(backend="flat", seed=3), device="cpu")
    assert ti.segment_count == 1 and ti.delta_size == 0
    np.testing.assert_array_equal(ti._a, flat.impl.family.a.numpy())
    q = _queries(data, 6, seed=21)
    np.testing.assert_array_equal(ti.search(q, K).indices, flat.search(q, K).indices)


def test_use_kernels_false_reaches_every_source():
    data = make_clustered(600, D, seed=22)
    ti = build_index(data, IndexConfig(backend="streaming",
                                       options={**OPTS, "use_kernels": False}),
                     device="cpu")
    ti.insert(make_clustered(10, D, seed=23))
    assert ti._force == "plain"
    assert all(s.index.force == "plain" for s in ti.segments)
    assert all(isinstance(s.index, FlatBackend) for s in ti.segments)


def test_delta_rows_grow_on_the_device_by_doubling():
    ti = build_index(np.empty((0, 4), np.float32), IndexConfig(
        backend="streaming", options={**OPTS, "delta_threshold": 5000}), device="cpu")
    rng = np.random.default_rng(24)
    x = rng.normal(size=(1500, 4)).astype(np.float32)
    ti.insert(x[:1000])
    assert ti.delta._rows.shape[0] == 1024
    ti.insert(x[1000:])
    assert ti.delta._rows.shape[0] == 2048
    ti.delete(np.arange(0, 1500, 3))
    np.testing.assert_array_equal(ti.delta.vectors.numpy(),
                                  x[np.setdiff1d(np.arange(1500), np.arange(0, 1500, 3))])
    assert ti.delta.vectors.device == torch.device("cpu")
    buf = ti.delta._rows.data_ptr()
    ti.flush()  # the segment takes the buffer; the delta lets go of it
    assert ti.delta._rows.shape[0] == 0 and ti.delta_size == 0
    assert ti.segments[-1].index.impl.data.data_ptr() == buf
    ti.insert(np.ones((6000, 4), np.float32))  # a bulk insert, sealed at once
    assert ti.delta_size == 0 and ti.delta._rows.shape[0] == 0
    # the segments' rows are their own: the delta's next buffer is new
    ti.insert(x[:3])
    np.testing.assert_array_equal(ti.segments[-1].index.impl.data.numpy(),
                                  np.ones((6000, 4), np.float32))
    np.testing.assert_array_equal(ti.segments[0].index.impl.data.numpy(),
                                  x[np.setdiff1d(np.arange(1500), np.arange(0, 1500, 3))])


def test_traced_search_splits_into_segment_delta_and_merge():
    data = make_clustered(2000, D, seed=25)
    _, ti = _pair(data)
    ti.insert(make_clustered(40, D, seed=26))
    with trace.trace() as tr:
        ti.search(_queries(data, 4, seed=27), K)
    names = [s.name for s in tr.spans]
    # the facade's root, then the stream's split; the sealed segment's
    # own flat facade opens its index.search inside stream.segment, with
    # the unfused pipeline's one ann.query span; the delta scan's and the
    # merge's kernels open their kernel spans
    assert names == ["index.search", "stream.search", "stream.segment", "index.search",
                     "ann.query", "stream.delta", "kernel.pairwise_sq_dist",
                     "kernel.topk_smallest", "stream.merge", "kernel.topk_smallest"]
    assert [s.parent for s in tr.spans] == [-1, 0, 1, 2, 3, 1, 5, 5, 1, 8]
    assert tr.spans[0].attrs["backend"] == "streaming"
    assert tr.spans[2].attrs["size"] == 2000 and tr.spans[5].attrs["size"] == 40
    assert not trace.enabled()


def test_traced_search_spans_match_jax():
    """The port's whole span tree is the reference's: the facade's root,
    the stream's split, each segment's facade with its ``ann.query``
    (one span: the reference runs the unfused pipeline as one jit call)
    and the delta scan's and merge's ``kernel.*`` spans, with their
    modeled bytes and FLOPs."""
    from repro.obs import trace as jtrace

    data = make_clustered(2000, D, seed=25)
    ji, ti = _pair(data)
    extra = make_clustered(40, D, seed=26)
    ji.insert(extra)
    ti.insert(extra)
    q = _queries(data, 4, seed=27)
    with jtrace.trace() as jtr:
        ji.search(q, K)
    with trace.trace() as ttr:
        ti.search(q, K)

    def tree(spans):
        return [(s.name, s.parent, s.attrs.get("bytes"), s.attrs.get("flops"))
                for s in spans]

    assert tree(ttr.spans) == tree(jtr.spans)
    assert any(s.name.startswith("kernel.") for s in ttr.spans)


def test_cpu_run_launches_no_kernel():
    data = make_clustered(600, D, seed=28)
    _, ti = _pair(data)
    ti.insert(make_clustered(10, D, seed=29))
    before = dict(counts.LAUNCHES)
    ti.search(_queries(data, 3, seed=30), K)
    ti.cp_search(5)
    assert counts.LAUNCHES == before
