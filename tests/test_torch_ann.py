"""The port's paper-faithful PM-LSH index (Algorithms 1-5) and its
``pmtree`` facade held against the JAX package's.

Both sides index the same ``make_clustered`` data; the port's index is
given the JAX index's A and ``projected``, so its trees are the JAX
index's.  Each side projects its queries itself (the port on
``device="cpu"``, summing in float64 and rounding once; JAX in float32),
so the projected queries may differ in the last bit; on these inputs no
range test falls within that difference, and the ids, every work
counter and the rounds must be identical.  Distances are the host's
numpy in both packages: rtol 1e-5.
"""
import numpy as np
import pytest

from conftest import make_clustered
from repro.core import ann as jann
from repro.core import cp as jcp
from repro.core import estimator as jest
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro_torch.core import ann as tann
from repro_torch.core import cp as tcp
from repro_torch.core import estimator as test_
from repro_torch.index import IndexConfig, PMTreeBackend, build_index

D = 32


@pytest.fixture(scope="module")
def data():
    return make_clustered(1200, D, n_clusters=15, seed=21)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.default_rng(22)
    return (data[rng.integers(0, len(data), 6)]
            + 0.2 * rng.normal(size=(6, D))).astype(np.float32)


def _pmlsh_pair(data, **kw):
    j = jann.PMLSH(data, c=1.5, m=15, seed=0, **kw)
    t = tann.PMLSH(data, c=1.5, m=15, seed=0, a=np.asarray(j.family.a),
                   projected=j.projected, device="cpu", **kw)
    return j, t


@pytest.fixture(scope="module")
def pmlsh(data):
    return _pmlsh_pair(data)


def _same_ann(rj, rt):
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert (rt.rounds, rt.candidates_verified) == (rj.rounds, rj.candidates_verified)
    assert vars(rt.stats) == vars(rj.stats)
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32


def test_trees_and_parameters_identical(pmlsh):
    j, t = pmlsh
    for name in ("centers", "radii", "hr_min", "hr_max", "parent", "perm", "points",
                 "level_offsets", "pivots"):
        np.testing.assert_array_equal(getattr(t.tree, name), getattr(j.tree, name))
    assert (t.t, t.beta, t.rmin(10)) == (j.t, j.beta, j.rmin(10))


@pytest.mark.parametrize("k", [1, 10, 50])
def test_ann_query_matches_jax(pmlsh, queries, k):
    j, t = pmlsh
    for q in queries:
        _same_ann(j.ann_query(q, k=k), t.ann_query(q, k=k))


def test_ann_query_at_a_given_rmin(pmlsh, queries):
    j, t = pmlsh
    _same_ann(j.ann_query(queries[0], k=5, rmin=0.5), t.ann_query(queries[0], k=5, rmin=0.5))


@pytest.mark.parametrize("r", [0.3, 1.0, 3.0])
def test_bc_query_matches_jax(pmlsh, queries, r):
    j, t = pmlsh
    for q in queries:
        (ij, sj), (it, st) = j.bc_query(q, r), t.bc_query(q, r)
        assert it == ij and vars(st) == vars(sj)


@pytest.mark.parametrize("promote", ["m_RAD", "random"])
def test_insert_builder_matches_jax(data, queries, promote):
    j, t = _pmlsh_pair(data[:400], builder="insert", promote=promote)
    np.testing.assert_array_equal(t.tree.centers, j.tree.centers)
    for q in queries[:3]:
        _same_ann(j.ann_query(q, k=10), t.ann_query(q, k=10))


def test_exact_knn_matches_jax(pmlsh, queries):
    j, t = pmlsh
    (ij, dj), (it, dt) = j.exact_knn(queries[1], 10), t.exact_knn(queries[1], 10)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-6)


@pytest.mark.parametrize("beta,k", [(0.05, 10), (0.2, 1)])
def test_select_rmin_matches_jax(data, beta, k):
    assert test_.select_rmin(data, beta, k, n_samples=20_000) == jest.select_rmin(
        data, beta, k, n_samples=20_000)
    for a, b in zip(test_.empirical_distance_distribution(data, 5000, seed=3),
                    jest.empirical_distance_distribution(data, 5000, seed=3)):
        np.testing.assert_array_equal(a, b)


# -- closest pair (Algorithms 3-5) ------------------------------------------


@pytest.fixture(scope="module")
def cp_pair(data):
    sub = data[:400]
    j = jcp.PMLSH_CP(sub, seed=0)
    t = tcp.PMLSH_CP(sub, seed=0, a=np.asarray(j.family.a), projected=j.projected,
                     device="cpu")
    return j, t


def _same_cp(rj, rt):
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert (rt.pairs_verified, rt.nodes_examined) == (rj.pairs_verified, rj.nodes_examined)


@pytest.mark.parametrize("k,T", [(1, None), (10, None), (10, 2_000), (10, 60_000)])
def test_cp_query_matches_jax(cp_pair, k, T):
    j, t = cp_pair
    assert t.gamma == j.gamma
    _same_cp(j.cp_query(k=k, T=T), t.cp_query(k=k, T=T))


@pytest.mark.parametrize("k,T", [(3, 200), (5, 1_000)])
def test_cp_query_bb_matches_jax(cp_pair, k, T):
    j, t = cp_pair
    _same_cp(j.cp_query_bb(k=k, T=T), t.cp_query_bb(k=k, T=T))


@pytest.mark.parametrize("k", [1, 10])
def test_exact_cp_matches_jax(cp_pair, k):
    j, t = cp_pair
    rj, rt = j.exact_cp(k=k, block=128), t.exact_cp(k=k, block=128)
    _same_cp(rj, rt)
    assert rt.pairs_verified == 400 * 399 // 2


@pytest.mark.parametrize("pr", [0.5, 0.85])
def test_calibrate_gamma_matches_jax(cp_pair, pr):
    j, t = cp_pair
    assert tcp.calibrate_gamma(t.tree, pr=pr, n_pairs=20_000) == jcp.calibrate_gamma(
        j.tree, pr=pr, n_pairs=20_000)


def test_insert_built_cp_matches_jax(data):
    sub = data[:300]
    j = jcp.PMLSH_CP(sub, seed=1, builder="insert")
    t = tcp.PMLSH_CP(sub, seed=1, builder="insert", a=np.asarray(j.family.a),
                     projected=j.projected, device="cpu")
    _same_cp(j.cp_query(k=5), t.cp_query(k=5))


# -- the pmtree facade --------------------------------------------------------


def _facade_pair(data, options=None, **cfg):
    ji = jax_build_index(data, JaxConfig(backend="pmtree", options=options or {}, **cfg))
    ti = PMTreeBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected),
        IndexConfig(backend="pmtree", options=options or {}, **cfg), device="cpu")
    return ji, ti


@pytest.fixture(scope="module")
def facade(data):
    return _facade_pair(data)


def _same_search(rj, rt):
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32


@pytest.mark.parametrize("k", [1, 10])
def test_facade_search_matches_jax(facade, queries, k):
    ji, ti = facade
    _same_search(ji.search(queries, k), ti.search(queries, k))


def test_facade_rejects_non_finite_rows_as_jax(facade, queries):
    ji, ti = facade
    q = queries[:3].copy()
    q[1, 4] = np.nan
    rt = ti.search(q, 5)
    _same_search(ji.search(q, 5), rt)
    assert rt.stats.queries_rejected == 1 and (rt.indices[1] == -1).all()


def test_facade_pads_k_beyond_n_as_jax(data, queries):
    ji, ti = _facade_pair(data[:30])
    rj, rt = ji.search(queries[:2], 40), ti.search(queries[:2], 40)
    _same_search(rj, rt)
    assert rt.indices.shape == (2, 40) and (rt.indices[:, 30:] == -1).all()


@pytest.mark.parametrize("options", [{}, {"cp_T": 20_000}])
def test_facade_cp_search_matches_jax(data, options):
    ji, ti = _facade_pair(data[:500], options)
    rj, rt = ji.cp_search(10), ti.cp_search(10)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert rt.stats.as_dict() == rj.stats.as_dict()


def test_facade_options_reach_the_trees_as_jax(data, queries):
    ji, ti = _facade_pair(data[:600], {"s": 3, "capacity": 8, "fanout": 3})
    assert ti.impl.tree.n_pivots == 3 and ti.impl.tree.n_nodes == ji.impl.tree.n_nodes
    _same_search(ji.search(queries[:2], 10), ti.search(queries[:2], 10))


def test_own_projection_answers_well(data, queries):
    """The port's own draw of A (a torch.Generator), on the CPU."""
    index = build_index(data, IndexConfig(backend="pmtree"), device="cpu")
    res = index.search(queries, 10)
    exact = np.argsort(((queries[:, None, :] - data[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(res.indices[i]) & set(exact[i])) / 10
                      for i in range(len(queries))])
    assert recall > 0.8 and res.stats.rounds >= len(queries)
    assert index.cp_search(5).pairs.shape == (5, 2)
