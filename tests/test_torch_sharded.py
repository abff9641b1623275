"""The port's sharded backends held against the JAX package's.

Every tier-1 case of ``tests/test_sharded.py`` runs here on the same
numpy inputs through both packages.  The JAX side runs as its own tests
run it: the emulated mesh with ``force="ref"``.  The port's index is
built from the JAX index's A and float32 projection (and, for pq, its
per-shard codecs and codes) on the CPU, where every kernel takes its
plain version.  ids must be identical to JAX's and to the port's own
``flat``; distances are bit-identical to the port's ``flat`` (the same
arithmetic on the same rows) and within rtol 1e-5 of JAX's, which sums
in another order.  CP pairs and both counters are identical to JAX's.

The legacy ``sharded`` backend runs at P = 1 against JAX's one-device
mesh; ``test_torch_sharded_dist.py`` holds its P = 2 and 4 against the
JAX mesh path and the process-group form against the emulated one.
"""
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro_torch.convert import codec_from_arrays
from repro_torch.core.sharded import BISECT_ROUNDS, ShardedFlatIndex, pad_rows
from repro_torch.index import (
    FlatBackend,
    IndexConfig,
    ShardedBackend,
    ShardedFlatBackend,
    ShardedFlatPQBackend,
    build_index,
)
from repro_torch.launch import DataMesh, index_row_split, make_data_mesh, shard_rows

FORCE = {"force": "ref"}


def _queries(data, B, seed=3):
    r = np.random.default_rng(seed)
    return (data[r.choice(len(data), B, replace=False)]
            + r.normal(size=(B, data.shape[1])).astype(np.float32) * 0.05)


def _jax(data, P, backend="sharded-flat", **opts):
    return jax_build_index(data, JaxConfig(
        backend=backend, options={"shards": P, "emulate": True, **FORCE, **opts}))


def _port(ji, data, P, backend="sharded-flat", **opts):
    """The port's index over the JAX index's arrays, emulated, on the CPU."""
    impl = ji.impl
    projected = np.asarray(impl._proj_blocks).reshape(-1, impl.m)[:len(data)]
    kw = {}
    if impl.codecs is not None:
        kw = dict(codecs=[codec_from_arrays(centroids=np.asarray(c.centroids), d=c.d,
                                            device="cpu") for c in impl.codecs],
                  codes=np.asarray(impl._codes_blocks))
    cls = ShardedFlatPQBackend if backend == "sharded-flat-pq" else ShardedFlatBackend
    return cls.from_arrays(data, np.asarray(impl.family.a), projected,
                           IndexConfig(backend=backend,
                                       options={"shards": P, "emulate": True, **opts}),
                           device="cpu", **kw)


def _port_flat(ji, data):
    impl = ji.impl
    projected = np.asarray(impl._proj_blocks).reshape(-1, impl.m)[:len(data)]
    return FlatBackend.from_arrays(data, np.asarray(impl.family.a), projected,
                                   IndexConfig(backend="flat"), device="cpu")


_TRIPLES = {}


def _triple(n, d, seed, P, backend="sharded-flat", **data_kw):
    """(data, JAX sharded, port sharded, port flat) over one data set."""
    key = (n, d, seed, P, backend, tuple(sorted(data_kw.items())))
    if key not in _TRIPLES:
        data = make_clustered(n, d, seed=seed, **data_kw)
        ji = _jax(data, P, backend)
        _TRIPLES[key] = data, ji, _port(ji, data, P, backend), _port_flat(ji, data)
    return _TRIPLES[key]


def _stats(res) -> dict:
    return res.stats.as_dict()


def _same_ann(rj, rt, rf, what=""):
    np.testing.assert_array_equal(rt.indices, rj.indices, err_msg=what)
    np.testing.assert_array_equal(rt.indices, rf.indices, err_msg=what)
    np.testing.assert_array_equal(rt.distances, rf.distances, err_msg=what)  # bit for bit
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5, err_msg=what)
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32


# ---------------------------------------------------------------------------
# ANN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("B,k", [(1, 1), (1, 10), (7, 1), (7, 10)])
def test_ann_parity_with_jax_and_flat(P, B, k):
    data, ji, ti, tf = _triple(203, 24, 11, P)  # 203 ∤ P for every P > 1
    q = _queries(data, B)
    rj, rt = ji.search(q, k), ti.search(q, k)
    _same_ann(rj, rt, tf.search(q, k), f"P={P} B={B} k={k}")
    assert _stats(rt) == _stats(rj)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_padding_never_surfaces(P):
    data, ji, ti, _ = _triple(101, 16, 5, P)
    q = _queries(data, 7)
    r = ti.search(q, 10)
    assert 0 <= r.indices.min() and r.indices.max() < 101
    assert np.all(np.isfinite(r.distances))
    np.testing.assert_array_equal(r.indices, ji.search(q, 10).indices)


def test_k_exceeds_per_shard_n():
    data, ji, ti, tf = _triple(20, 8, 7, 8)  # ≤ 3 rows a shard, k = 15
    q = _queries(data, 3)
    _same_ann(ji.search(q, 15), ti.search(q, 15), tf.search(q, 15))


def test_shards_exceed_points():
    data, ji, ti, tf = _triple(5, 8, 9, 8)  # shards of padding only
    q = _queries(data, 2)
    _same_ann(ji.search(q, 3), ti.search(q, 3), tf.search(q, 3))


def test_nan_queries_rejected():
    data, ji, ti, _ = _triple(120, 8, 1, 4)
    q = _queries(data, 4)
    q[2] = np.nan
    rj, rt = ji.search(q, 5), ti.search(q, 5)
    assert rt.stats.queries_rejected == rj.stats.queries_rejected == 1
    assert np.all(rt.indices[2] == -1) and np.all(np.isinf(rt.distances[2]))
    np.testing.assert_array_equal(rt.indices, rj.indices)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_workstats_sum_matches_flat(P):
    data, ji, ti, tf = _triple(203, 24, 11, P)
    q = _queries(data, 7)
    rt, rf = ti.search(q, 10), tf.search(q, 10)
    assert rt.stats.candidates_selected == rf.stats.candidates_selected
    assert rt.stats.shards == P
    assert rt.stats.max_shard_candidates * P >= rt.stats.candidates_selected
    assert rt.stats.max_shard_candidates <= rt.stats.candidates_selected
    assert _stats(rt) == _stats(ji.search(q, 10))


@pytest.mark.parametrize("P", [2, 4])
def test_workstats_cp_pruning_off(P):
    data = make_clustered(150, 16, seed=3)
    n = len(data)
    ji = _jax(data, P, cp_gamma=np.inf)
    ti = _port(ji, data, P, cp_gamma=np.inf)
    rj, rt = ji.cp_search(5), ti.cp_search(5)
    assert rt.stats.pairs_verified == n * (n - 1) // 2
    assert rt.stats.max_shard_pairs * P >= rt.stats.pairs_verified
    assert _stats(rt) == _stats(rj)


# ---------------------------------------------------------------------------
# CP
# ---------------------------------------------------------------------------


def _same_cp(rj, rt, rf=None):
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-6)
    assert (rt.stats.pairs_verified, rt.stats.tiles_pruned, rt.stats.max_shard_pairs) == \
        (rj.stats.pairs_verified, rj.stats.tiles_pruned, rj.stats.max_shard_pairs)
    if rf is not None:
        np.testing.assert_array_equal(rt.pairs, rf.pairs)
        np.testing.assert_array_equal(rt.distances, rf.distances)  # bit for bit


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_cp_parity_with_jax_and_flat(P):
    data, ji, ti, tf = _triple(203, 16, 2, P)
    _same_cp(ji.cp_search(6), ti.cp_search(6), tf.cp_search(6))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_cp_parity_under_active_pruning(P):
    # separated clusters: the tile filter fires on cross-shard tiles and
    # must never prune a true top-k pair
    data, ji, ti, tf = _triple(520, 16, 4, P, n_clusters=20, spread=0.3, scale=8.0)
    rt = ti.cp_search(6)
    _same_cp(ji.cp_search(6), rt, tf.cp_search(6))
    assert rt.stats.tiles_pruned > 0


@pytest.mark.parametrize("P", [2, 8])
def test_cp_planted_pair(P):
    data = make_clustered(160, 12, seed=8)
    data[57] = data[23] + np.float32(1e-3)
    ji = _jax(data, P)
    rt = _port(ji, data, P).cp_search(1)
    assert tuple(rt.pairs[0]) == (23, 57)
    _same_cp(ji.cp_search(1), rt)


# ---------------------------------------------------------------------------
# per-shard PQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_pq_recall_floor_and_jax_parity(P):
    data, ji, ti, tf = _triple(600, 32, 6, P, "sharded-flat-pq", n_clusters=12)
    q = _queries(data, 8)
    k = 10
    exact = tf.search(q, k)

    def recall(r):
        return np.mean([len(set(a) & set(b)) / k for a, b in zip(exact.indices, r.indices)])

    fpq = build_index(data, IndexConfig(backend="flat-pq"), device="cpu").search(q, k)
    rt, rj = ti.search(q, k), ji.search(q, k)
    assert recall(rt) >= 0.95 * recall(fpq)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert _stats(rt) == _stats(rj) and rt.stats.point_distance_computations > 0
    assert ti.bytes_per_point() == pytest.approx(ji.bytes_per_point(), rel=1e-12)


def test_pq_cp_stays_exact():
    data, ji, ti, tf = _triple(180, 16, 12, 4, "sharded-flat-pq")
    _same_cp(ji.cp_search(4), ti.cp_search(4), tf.cp_search(4))


def test_pq_trains_its_own_codecs():
    """Built without JAX's codecs: one codec a shard (seed + p), codes of
    every padded row, recall near the JAX-coded index's."""
    data, ji, ti, tf = _triple(600, 32, 6, 4, "sharded-flat-pq", n_clusters=12)
    own = build_index(data, IndexConfig(backend="sharded-flat-pq",
                                        options={"shards": 4, "emulate": True}), device="cpu")
    assert len(own.impl.codecs) == 4
    assert all(s.codes.shape == (own.impl.nl, 16) for s in own.impl._shards)
    q = _queries(data, 8)
    exact = tf.search(q, 10).indices
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(exact, own.search(q, 10).indices)])
    assert rec >= 0.9


# ---------------------------------------------------------------------------
# tracing, merge, rooflines, registry
# ---------------------------------------------------------------------------


def _tree(spans):
    return [(s.name, s.parent, {k: v for k, v in s.attrs.items()
                                if k not in ("candidates_selected", "work")})
            for s in spans]


@pytest.mark.parametrize("backend", ["sharded-flat", "sharded-flat-pq"])
def test_traced_span_tree_matches_jax(backend):
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace

    data, ji, ti, _ = _triple(150, 16, 10, 4, backend)
    q = _queries(data, 4)
    plain = ti.search(q, 5)
    with jtrace.trace() as jtr:
        ji.search(q, 5)
        ji.cp_search(3)
    with trace.trace() as ttr:
        traced = ti.search(q, 5)
        ti.cp_search(3)
    assert _tree(ttr.spans) == _tree(jtr.spans)
    np.testing.assert_array_equal(plain.indices, traced.indices)
    np.testing.assert_array_equal(plain.distances, traced.distances)
    sel = [s.attrs["candidates_selected"] for s in ttr.spans if s.name == "shard.select"]
    assert sel == [s.attrs["candidates_selected"] for s in jtr.spans
                   if s.name == "shard.select"]
    assert all(s.attrs["bytes"] > 0 for s in ttr.spans if s.name == "shard.exchange")
    assert not trace.enabled()


def _pools(case):
    r = np.random.default_rng(case)
    B, L = 5, 24
    d2 = r.uniform(0, 4, size=(B, L)).astype(np.float32)
    gid = r.permutation(B * L).reshape(B, L).astype(np.int32)
    if case == 1:  # +inf pads: a shard short of survivors
        d2[:, 16:] = np.inf
        gid[:, 16:] = -1
    if case == 2:  # ties across shards' slots
        d2[:, ::3] = d2[:, :1]
    if case == 3:  # fewer finite entries than k in a row
        d2[0, 2:] = np.inf
    return d2, gid


@pytest.mark.parametrize("case", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 10])
def test_merge_topk_matches_jax(case, k):
    import jax.numpy as jnp
    from repro.kernels import merge as jmerge
    from repro_torch.kernels import merge

    d2, gid = _pools(case)
    wi, wd = jmerge.merge_topk_ref(jnp.asarray(d2), jnp.asarray(gid), k)
    gi, gd = merge.merge_topk(torch.from_numpy(d2), torch.from_numpy(gid), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # the pooled d² are the same floats; the two frameworks' vectorised
    # CPU square roots may round an ulp apart
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32


@pytest.mark.parametrize("model,args", [
    ("shard_exchange_cost", (4, 64, 10)),
    ("shard_exchange_cost", (8, 1, 1, 16)),
    ("shard_merge_cost", (4, 64, 10)),
    ("shard_merge_cost", (3, 1, 128)),
    ("shard_ring_cost", (4, 13696, 192, 10)),
    ("shard_ring_cost", (2, 128, 16, 6)),
])
def test_shard_roofline_models_equal_the_reference(model, args):
    from repro.obs import roofline as jroof
    from repro_torch.obs import roofline

    want, got = getattr(jroof, model)(*args), getattr(roofline, model)(*args)
    assert (got.bytes, got.flops, got.attrs()) == (want.bytes, want.flops, want.attrs())


def test_bytes_per_point_matches_jax():
    data, ji, ti, _ = _triple(203, 24, 11, 4)
    assert ti.bytes_per_point() == ji.bytes_per_point()
    assert ti.raw_bytes_per_point() == ji.raw_bytes_per_point()


# ---------------------------------------------------------------------------
# layout, mesh and options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,P,multiple", [(203, 4, 1), (5, 8, 1), (203, 2, 64), (1, 1, 1)])
def test_row_split_and_padding_match_the_reference(n, P, multiple):
    from repro.core import sharded as jsharded
    from repro.launch.sharding import index_row_pspec

    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = jsharded.pad_rows(arr, P, fill=-1.0, multiple=multiple)
    np.testing.assert_array_equal(pad_rows(arr, P, fill=-1.0, multiple=multiple), want)
    nl = shard_rows(n, P, multiple)
    assert nl * P == want.shape[0]
    split = index_row_split(n, P, multiple)
    assert [(s.start, s.stop) for s in split] == [(p * nl, (p + 1) * nl) for p in range(P)]
    assert tuple(index_row_pspec(2)) == ("data", None)  # rows split, columns whole


def test_emulated_mesh_collectives():
    mesh = DataMesh(size=3, device=torch.device("cpu"))
    xs = [torch.tensor([1, 5], dtype=torch.int32), torch.tensor([2, 0], dtype=torch.int32),
          torch.tensor([4, 1], dtype=torch.int32)]
    assert mesh.psum(xs).tolist() == [7, 6] and mesh.psum(xs).dtype == torch.int32
    assert mesh.pmax([x.float() for x in xs]).tolist() == [4.0, 5.0]
    assert [t.tolist() for t in mesh.all_gather(xs)] == [[1, 5], [2, 0], [4, 1]]
    assert [t[0].tolist() for t in mesh.ring([(x,) for x in xs])] == [[4, 1], [1, 5], [2, 0]]
    assert mesh.local == (0, 1, 2) and mesh.emulated and mesh.rank is None
    with pytest.raises(ValueError, match="2 values for 3 local shards"):
        mesh.psum(xs[:2])


def test_make_data_mesh_without_a_group():
    mesh = make_data_mesh(device="cpu")
    assert (mesh.size, mesh.emulated, mesh.axis) == (1, True, "data")
    assert make_data_mesh(4, "rows", device="cpu").size == 4
    with pytest.raises(ValueError, match="at least one shard"):
        make_data_mesh(0, device="cpu")


def test_force_option_selects_the_plain_versions(monkeypatch):
    from repro_torch.kernels import ops

    seen = []
    real = ops._plain

    def spy(f, *tensors):
        seen.append(f)
        return real(f, *tensors)

    monkeypatch.setattr(ops, "_plain", spy)
    data = make_clustered(120, 8, seed=1)
    for force, want in ((None, None), ("ref", "plain"), ("plain", "plain")):
        seen.clear()
        index = build_index(data, IndexConfig(backend="sharded-flat", options={
            "shards": 2, "force": force}), device="cpu")
        index.search(_queries(data, 3), 5)
        index.cp_search(3)
        assert index.force == want and seen and set(seen) == {want}
    with pytest.raises(ValueError, match="force"):
        build_index(data, IndexConfig(backend="sharded-flat",
                                      options={"force": "interpret"}), device="cpu")


def test_from_arrays_index_and_query_tensors():
    """``ShardedFlatIndex`` directly: device tensors out, counts (P, B)
    summing to at least T per query."""
    data, ji, ti, _ = _triple(203, 24, 11, 4)
    projected = np.asarray(ji.impl._proj_blocks).reshape(-1, 15)[:203]
    idx = ShardedFlatIndex.from_arrays(data, np.asarray(ji.impl.family.a), projected,
                                       shards=4, emulate=True, device="cpu")
    q = torch.from_numpy(_queries(data, 7))
    ids, dd, counts = idx.query(q, 10, 40)
    assert ids.dtype == torch.int32 and dd.shape == (7, 10) and counts.shape == (4, 7)
    assert bool((counts.sum(0) >= 40).all())
    assert (idx.P, idx.nl, BISECT_ROUNDS) == (4, 51, 32)


# ---------------------------------------------------------------------------
# the legacy ``sharded`` backend at P = 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def legacy_pair():
    data = make_clustered(203, 24, seed=11)
    ji = jax_build_index(data, JaxConfig(backend="sharded", options={"devices": 1}))
    ti = ShardedBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.proj_sh)[:203],
        IndexConfig(backend="sharded", options={"devices": 1}), device="cpu")
    return data, ji, ti


@pytest.mark.parametrize("B,k", [(1, 1), (7, 10)])
def test_legacy_ann_matches_jax_at_one_shard(legacy_pair, B, k):
    data, ji, ti = legacy_pair
    q = _queries(data, B)
    rj, rt = ji.search(q, k), ti.search(q, k)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert _stats(rt) == _stats(rj)


def test_legacy_cp_matches_jax_at_one_shard(legacy_pair):
    data, ji, ti = legacy_pair
    rj, rt = ji.cp_search(6), ti.cp_search(6)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_array_equal(rt.distances, rj.distances)
    assert _stats(rt) == _stats(rj)
