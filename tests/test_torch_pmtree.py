"""The port's PM-tree, range queries and hash families held against the
JAX package's on the same numpy inputs.

The builders are numpy in both packages, so from one projected array the
trees must be identical field by field.  The host DFS is numpy too: its
slots and ``QueryStats`` must be identical.  The device range mask runs
here on the CPU: torch's norms sum in another order than XLA's, so a
point whose projected distance lies within 1e-6 (relative) of the radius
may fall either way; the masks must be equal outside that band, and the
test asserts the band is empty on these inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.core import pmtree as jpm
from repro.core import pmtree_query as jpq
from repro.core.hashing import BucketFamily as JaxBucketFamily
from repro_torch.core import pmtree as tpm
from repro_torch.core import pmtree_query as tpq
from repro_torch.core.hashing import BucketFamily, ProjectionFamily, hash_to_host
from repro_torch.index import PMTreeBackend

BAND = 1e-6


@pytest.fixture(scope="module")
def projected():
    """A clustered 15-d point set, as PM-LSH's projection gives it."""
    return make_clustered(900, 15, n_clusters=12, seed=7)


_BUILDS = {
    "bulk-fanout2": ("build_bulk", {"fanout": 2}),
    "bulk-fanout4": ("build_bulk", {"fanout": 4}),
    "bulk-fanout16": ("build_bulk", {"fanout": 16, "capacity": 8}),
    "insert-mRAD": ("build_insert", {"promote": "m_RAD"}),
    "insert-random": ("build_insert", {"promote": "random"}),
}


_TREES = {}


def _trees(projected, case):
    """(JAX tree, port tree) of ``case``, built once per module."""
    if case not in _TREES:
        name, kw = _BUILDS[case]
        kw = {"capacity": 16, "n_pivots": 5, "seed": 3, **kw}
        _TREES[case] = (getattr(jpm, name)(projected, **kw),
                        getattr(tpm, name)(projected, **kw))
    return _TREES[case]


def _same_tree(jt, tt):
    for f in dataclasses.fields(jpm.FlatPMTree):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


@pytest.mark.parametrize("case", sorted(_BUILDS))
def test_trees_identical_field_by_field(projected, case):
    jt, tt = _trees(projected, case)
    _same_tree(jt, tt)
    tt.validate()
    assert tt.n_points == projected.shape[0] and tt.depth > 1


@pytest.mark.parametrize("points", ["duplicates", "tiny"])
def test_degenerate_trees_identical(points):
    pts = (np.zeros((100, 8), np.float32) if points == "duplicates"
           else np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32))
    jt, tt = jpm.build_bulk(pts, capacity=8), tpm.build_bulk(pts, capacity=8)
    _same_tree(jt, tt)
    tt.validate()


def test_select_pivots_identical(projected):
    np.testing.assert_array_equal(tpm.select_pivots(projected, 5, seed=2),
                                  jpm.select_pivots(projected, 5, seed=2))


def _queries(projected, count, seed):
    rng = np.random.default_rng(seed)
    return (projected[rng.integers(0, projected.shape[0], count)]
            + rng.normal(size=(count, projected.shape[1]))).astype(np.float32)


@pytest.mark.parametrize("radius", [0.5, 2.0, 6.0])
@pytest.mark.parametrize("case", ["bulk-fanout4", "insert-mRAD"])
def test_range_query_host_identical(projected, case, radius):
    jt, tt = _trees(projected, case)
    for q in _queries(projected, 6, seed=int(radius * 10)):
        js, jst = jpq.range_query_host(jt, q, radius)
        ts, tst = tpq.range_query_host(tt, q, radius)
        np.testing.assert_array_equal(ts, js)
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
        brute = np.flatnonzero(np.linalg.norm(tt.points - q, axis=-1) <= radius)
        assert sorted(ts.tolist()) == brute.tolist()


def _band(tree, q, radius):
    """Slots whose projected distance is within BAND (relative) of radius."""
    dist = np.linalg.norm(tree.points.astype(np.float64) - q, axis=-1)
    return np.abs(dist - radius) <= BAND * radius


@pytest.mark.parametrize("radius", [0.5, 2.0, 6.0])
@pytest.mark.parametrize("case", ["bulk-fanout4", "bulk-fanout16", "insert-random"])
def test_range_mask_device_matches_jax(projected, case, radius):
    jt, tt = _trees(projected, case)
    jdt, tdt = jpq.DeviceTree.from_host(jt), tpq.DeviceTree.from_host(tt, "cpu")
    for q in _queries(projected, 5, seed=int(radius * 100)):
        jm = np.asarray(jpq.range_mask_device(jdt, jnp.asarray(q), radius))
        tm = tpq.range_mask_device(tdt, torch.from_numpy(q), radius).numpy()
        band = _band(tt, q, radius)
        assert not band.any(), f"{int(band.sum())} slots within the ±{BAND} band"
        np.testing.assert_array_equal(tm[~band], jm[~band])
        host, _ = tpq.range_query_host(tt, q, radius)
        assert set(np.flatnonzero(tm).tolist()) == set(host.tolist())


@pytest.mark.parametrize("max_results", [1, 32, 900])
def test_range_query_device_matches_jax(projected, max_results):
    jt, tt = _trees(projected, "bulk-fanout4")
    jdt, tdt = jpq.DeviceTree.from_host(jt), tpq.DeviceTree.from_host(tt, "cpu")
    for q in _queries(projected, 4, seed=max_results):
        ji, jd, jv = (np.asarray(a) for a in jpq.range_query_device(
            jdt, jnp.asarray(q), 2.5, max_results=max_results))
        ti, td, tv = (a.numpy() for a in tpq.range_query_device(
            tdt, torch.from_numpy(q), 2.5, max_results))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti[tv], ji[jv])
        np.testing.assert_allclose(td[tv], jd[jv], rtol=1e-6)
        assert (np.diff(td[tv]) >= 0).all()


def test_range_query_device_ties_go_to_the_lowest_slot():
    """Equal projected distances: lax.top_k's lowest-index order."""
    pts = np.repeat(np.eye(3, dtype=np.float32), 5, axis=0)  # 15 points, 3 values
    tt = tpm.build_bulk(pts, capacity=4, fanout=2)
    idx, d, valid = tpq.range_query_device(tpq.DeviceTree.from_host(tt, "cpu"),
                                           torch.zeros(3), 1.5, 15)
    assert bool(valid.all()) and bool((d == 1.0).all())
    assert idx.tolist() == list(range(15))


def test_device_tree_of_a_single_leaf():
    pts = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    tt = tpm.build_bulk(pts, capacity=16)
    mask = tpq.range_mask_device(tpq.DeviceTree.from_host(tt, "cpu"), torch.zeros(4), 100.0)
    assert tt.n_nodes == 1 and mask.tolist() == [True] * 3


@pytest.mark.parametrize("m,w", [(5, 4.0), (6, 2.5)])
def test_bucket_family_from_numpy_hashes_as_jax(m, w):
    data = make_clustered(1200, 32, seed=11)
    jf = JaxBucketFamily.create(32, m, w, seed=m)
    tf = BucketFamily.from_numpy(np.asarray(jf.a), np.asarray(jf.b), jf.w, "cpu")
    np.testing.assert_array_equal(hash_to_host(tf, data), np.asarray(jf.hash(data)))
    np.testing.assert_allclose(hash_to_host(tf, data, raw=True), np.asarray(jf.raw(data)),
                               rtol=1e-5, atol=1e-5)
    assert tf.hash(torch.from_numpy(data)).dtype == torch.int32


def test_bucket_family_draw():
    f1 = BucketFamily.create(16, 5, 4.0, seed=3, device="cpu")
    f2 = BucketFamily.create(16, 5, 4.0, seed=3, device="cpu")
    assert torch.equal(f1.a, f2.a) and torch.equal(f1.b, f2.b)
    assert tuple(f1.a.shape) == (16, 5) and bool((f1.b >= 0).all() & (f1.b < 4.0).all())
    with pytest.raises(ValueError, match="b"):
        BucketFamily.from_numpy(np.ones((4, 3)), np.ones(2), 1.0, "cpu")


def test_project_rounded_is_the_float64_sum_rounded_once():
    x = make_clustered(300, 48, seed=2)
    fam = ProjectionFamily.from_seed(48, 15, seed=0, device="cpu")
    want = (x.astype(np.float64) @ fam.a.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fam.project_rounded(torch.from_numpy(x)).numpy(), want)


def test_pmtree_backend_validates_given_arrays():
    data = make_clustered(64, 8, seed=1)
    with pytest.raises(ValueError, match="a is"):
        PMTreeBackend.from_arrays(data, np.ones((8, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="projected"):
        PMTreeBackend.from_arrays(data, np.ones((8, 15), np.float32),
                                  np.ones((63, 15), np.float32), device="cpu")
