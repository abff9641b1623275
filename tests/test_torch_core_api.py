"""The rest of ``repro_torch.core``'s public surface held against
``repro.core`` on the same numpy inputs: Lemma 2's estimate and Lemma
3's interval (exact: both sides are the same float arithmetic over
scipy's quantiles), Eq. 2's collision probability in float32, the
2-stable check given the reference's draws and on its own, and
``ann_search`` over an index carried across with the reference's A."""
import math

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from conftest import make_clustered
from repro.core import hashing as jhashing
from repro_torch.convert import flat_index_from_arrays
from repro_torch.core import hashing as thashing


@pytest.mark.parametrize("value", [7.25, np.array([[0.0, 3.5], [1e-3, 1e6]]),
                                   np.arange(12, dtype=np.float32).reshape(3, 4)])
@pytest.mark.parametrize("m", [1, 15])
def test_estimate_distance_sq_matches_jax(value, m):
    want = jcore.estimate_distance_sq(value, m)
    got = tcore.estimate_distance_sq(value, m)
    assert type(got) is type(want)
    np.testing.assert_array_equal(got, want)
    t = torch.as_tensor(value, dtype=torch.float64 if np.ndim(value) == 0 else None)
    got_t = tcore.estimate_distance_sq(t, m)
    assert got_t.device == t.device and got_t.dtype == t.dtype
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want, dtype=got_t.numpy().dtype))


@pytest.mark.parametrize("r, m, alpha", [(1.0, 15, 0.1), (2.5, 1, 0.05), (0.3, 30, 1 / math.e),
                                         (10.0, 8, 0.25), (1.7, 64, 0.001)])
def test_confidence_interval_matches_jax(r, m, alpha):
    lo, hi = tcore.confidence_interval(r, m, alpha)
    assert (lo, hi) == jcore.confidence_interval(r, m, alpha)
    assert lo < hi


TAUS = [0.0, -1.0, 1e-30, 0.5, 1.0, 4.0, 100.0, np.inf]


@pytest.mark.parametrize("w", [1.0, 4.0])
def test_collision_probability_matches_jax(w):
    taus = np.asarray(TAUS, np.float32)
    want = np.asarray(jhashing.collision_probability(taus, w))
    got = thashing.collision_probability(torch.from_numpy(taus), w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    # τ = +inf: (2/(√(2π)·0))·(1 − e⁰) = inf·0, NaN on both sides
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # τ ≤ 0 and τ below the clamp all read p(1e-20), a value near 1
    assert got[0] == got[1] == got[2] and abs(got[0] - 1.0) < 1e-6
    # scalars go through the same float32 path
    for tau in TAUS[:-1]:
        np.testing.assert_allclose(float(thashing.collision_probability(tau, w)),
                                   float(jhashing.collision_probability(tau, w)),
                                   rtol=1e-6, atol=1e-7)


def test_collision_probability_falls_with_distance():
    p = thashing.collision_probability(torch.tensor([0.5, 1.0, 2.0, 8.0]), 4.0)
    assert (p[1:] < p[:-1]).all() and ((p > 0) & (p < 1)).all()


@pytest.mark.parametrize("d, m", [(16, 15), (64, 8)])
def test_pstable_samples_match_jax_on_its_draws(d, m):
    jf = jhashing.ProjectionFamily.create(d, m, seed=3)
    want = jhashing.pstable_check(jf, n_samples=512, seed=1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    o1 = np.asarray(jax.random.normal(k1, (512, d)))
    o2 = np.asarray(jax.random.normal(k2, (512, d)))
    tf = thashing.ProjectionFamily.from_numpy(np.asarray(jf.a), "cpu")
    got = thashing._pstable_samples(tf, o1, o2)
    assert got.shape == want.shape == (512 * m,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pstable_check_own_draw_is_standard_normal():
    fam = thashing.ProjectionFamily.from_seed(32, 15, seed=0, device="cpu")
    rho = thashing.pstable_check(fam, n_samples=4096, seed=1)
    assert isinstance(rho, np.ndarray) and rho.shape == (4096 * 15,)
    assert abs(rho.mean()) <= 0.05
    assert 0.9 <= rho.var() <= 1.1
    np.testing.assert_array_equal(rho, thashing.pstable_check(fam, n_samples=4096, seed=1))


@pytest.fixture(scope="module")
def flat_pair():
    data = make_clustered(1500, 24, seed=11)
    ji = jcore.build_flat_index(data, m=15, seed=0, c=1.5)
    ti = flat_index_from_arrays(data, np.asarray(ji.family.a), np.asarray(ji.projected),
                                c=1.5, device="cpu")
    rng = np.random.default_rng(5)
    q = (data[rng.integers(0, len(data), 6)] + 0.2 * rng.normal(size=(6, 24))).astype(
        np.float32)
    return ji, ti, q


@pytest.mark.parametrize("c", [1.5, 2.0])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_ann_search_matches_jax(flat_pair, c, use_kernels, fused):
    ji, ti, q = flat_pair
    jids, jd = jcore.ann_search(ji, q, 10, c=c, use_kernels=use_kernels, fused=fused)
    tids, td = tcore.ann_search(ti, q, 10, c=c, use_kernels=use_kernels, fused=fused)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    assert tids.dtype == torch.int32 and td.dtype == torch.float32


def test_ann_search_takes_tensors_and_given_params(flat_pair):
    ji, ti, q = flat_pair
    params = jcore.solve_parameters(3.0, m=15)
    jids, _ = jcore.ann_search(ji, q[0], 5, params=params)
    tids, _ = tcore.ann_search(ti, torch.from_numpy(q[0]), 5,
                               params=tcore.solve_parameters(3.0, m=15))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_core_exports_match_the_reference():
    for name in ("confidence_interval", "estimate_distance_sq", "ann_search",
                 "select_pivots"):
        assert callable(getattr(tcore, name)) and hasattr(jcore, name)
    assert tcore.select_pivots is tcore.pmtree.select_pivots
    for name in ("collision_probability", "pstable_check"):
        assert callable(getattr(thashing, name))
    pts = make_clustered(300, 8, seed=2)
    np.testing.assert_array_equal(tcore.select_pivots(pts, 5, seed=1),
                                  jcore.select_pivots(pts, 5, seed=1))
