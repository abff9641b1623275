"""The port's kernels held against the JAX package's.

On the CPU the port's plain PyTorch versions (``repro_torch.kernels.ref``
through ``ops``) run against the JAX Pallas kernels in interpret mode
and against ``repro.kernels.ref``, on the same numpy inputs made from a
seed.  ``test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card.

Tolerances: pairwise distances agree to rtol/atol 1e-5 (float32 sums
in another order: BLAS against XLA); radius_select agrees exactly
(values are copies of the input, counts are integers, and both sides
form the thresholds with the same float32 operations); verify's ids
agree exactly and its d² to rtol 1e-5 (the TPU kernel uses the norm
trick, the port the difference form).  topk_smallest agrees exactly
with the JAX oracle (values and indices, +inf entries included) and
with the Pallas kernel on values, and on indices where the value is
finite (the Pallas kernel repeats indices in +inf slots).
project_dist agrees to |Δ| ≤ 1e-5·(|qp|² + |x·A|²) + 1e-6 (the
projection is summed in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pairwise_dist import pairwise_sq_dist_pallas
from repro.kernels.project_dist import project_dist_pallas
from repro.kernels.select import radius_select_pallas
from repro.kernels.topk import topk_smallest_pallas
from repro.kernels.verify import verify_topk_pallas
from repro_torch.kernels import counts, ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pairwise_sq_dist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [15, 64])
@pytest.mark.parametrize("N", [100, 300])
@pytest.mark.parametrize("B", [1, 5])
def test_pairwise_matches_pallas(B, N, d):
    rng = np.random.default_rng(B * 1000 + N + d)
    q = rng.normal(size=(B, d)).astype(np.float32)
    x = rng.normal(size=(N, d)).astype(np.float32)
    got = ops.pairwise_sq_dist(_t(q), _t(x)).numpy()
    assert got.shape == (B, N) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(pairwise_sq_dist_pallas(jnp.asarray(q), jnp.asarray(x),
                                                interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.pairwise_sq_dist(q, x)), **TOL)


@pytest.mark.parametrize("B,N,d", [(1, 7, 15), (4, 33, 16), (3, 50, 256)])
def test_pairwise_rows_matches_ref(B, N, d):
    """The per-query (B, N, d) form sums in the difference form."""
    rng = np.random.default_rng(B + N + d)
    q = rng.normal(size=(B, d)).astype(np.float32)
    x = rng.normal(size=(B, N, d)).astype(np.float32)
    got = ops.pairwise_sq_dist(_t(q), _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.pairwise_sq_dist(q, x)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.pairwise_sq_dist(jnp.asarray(q), jnp.asarray(x),
                                              force="interpret")), **TOL)


def test_topk_smallest_keeps_lowest_index_ties():
    """The stable sort that replaces lax.top_k outside the kernels."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 5, size=(4, 60)).astype(np.float32)  # many ties
    for k in (1, 7, 60):
        gv, gi = ref.topk_smallest(_t(d), k)
        wv, wi = jref.topk_smallest(d, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# radius_select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,T,T_pad,seed_scale", [
    (1, 100, 7, 71, 1.0),
    (3, 257, 40, 104, 1.0),
    (7, 700, 120, 184, 1.0),   # several TPU tiles
    (5, 300, 1, 65, 1.0),      # T = 1
    (2, 500, 30, 94, 1e-9),    # seed far below the ladder's reach
    (2, 500, 30, 94, 1e9),     # seed far above it
])
def test_radius_select_matches_pallas(B, N, T, T_pad, seed_scale):
    rng = np.random.default_rng(B * 1000 + N + T)
    d = (rng.normal(size=(B, N)) ** 2 * 3).astype(np.float32)  # ties-free
    tau0 = (d.mean(1) * max(T / N, 1e-3) * seed_scale).astype(np.float32)
    wv, wi, wc = radius_select_pallas(jnp.asarray(d), jnp.asarray(tau0), T,
                                      T_pad=T_pad, interpret=True)
    gv, gi, gc = ref.radius_select_kernel(_t(d), _t(tau0), T, T_pad=T_pad)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def _tie_cluster():
    d = np.full((1, 600), 5.0, np.float32)
    d[0, 597:] = 0.5  # the true top-T lives at the highest indices
    return d


@pytest.mark.parametrize("case", ["threshold", "overflow", "sort"])
def test_ops_radius_select_matches_jax(case):
    """The whole dispatch: seed, kernel, trim, and both sort routes."""
    rng = np.random.default_rng(11)
    if case == "threshold":
        d, T, T_pad = (rng.normal(size=(4, 640)) ** 2).astype(np.float32), 50, 120
    elif case == "overflow":  # 600 tied survivors cannot fit 100 slots
        d, T, T_pad = _tie_cluster(), 10, 100
    else:  # T_pad >= N: nothing to skip
        d, T, T_pad = (rng.normal(size=(3, 90)) ** 2).astype(np.float32), 20, 200
    wv, wi, wc = jops.radius_select(jnp.asarray(d), T, T_pad=T_pad,
                                    force="interpret", with_count=True)
    before = dict(counts.ROUTES)
    gv, gi, gc = ops.radius_select(_t(d), T, T_pad=T_pad, with_count=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    rerouted = {k for k, v in counts.ROUTES.items() if v != before[k]}
    assert rerouted == {"threshold": set(), "overflow": {"radius_select.overflow"},
                        "sort": {"radius_select.sort"}}[case]
    if case == "overflow":
        assert set(gi.numpy()[0, :3].tolist()) == {597, 598, 599}


# ---------------------------------------------------------------------------
# verify_topk
# ---------------------------------------------------------------------------


def _verify_inputs(B, n, d, Tc, pad, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:Tc] for _ in range(B)]).astype(np.int32)
    if pad:
        cand[:, Tc - pad:] = -1
    return data, q, cand


@pytest.mark.parametrize("B,n,d,Tc,k,pad", [
    (1, 50, 8, 10, 1, 0),
    (3, 300, 24, 80, 10, 0),
    (7, 129, 33, 64, 10, 20),   # -1 padding
    (2, 40, 12, 6, 10, 2),      # k > Tc, and padding
    (4, 513, 96, 200, 1, 0),
])
def test_verify_matches_pallas(B, n, d, Tc, k, pad):
    data, q, cand = _verify_inputs(B, n, d, Tc, pad, seed=B * 100 + n + Tc)
    wv, wi = verify_topk_pallas(jnp.asarray(data), jnp.asarray(q),
                                jnp.asarray(cand), k, interpret=True)
    gv, gi = ops.verify_topk(_t(data), _t(q), _t(cand), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    real = min(k, Tc - pad)
    assert (gi.numpy()[:, real:] == -1).all() and np.isinf(gv.numpy()[:, real:]).all()


@pytest.mark.parametrize("k", [1, 10])
def test_verify_exact_ties_go_to_earliest_position(k):
    """Rows 3 and 9 (and 4 and 8) are duplicates: each pair ties exactly,
    and the one at the earlier candidate position answers first."""
    rng = np.random.default_rng(21)
    data = rng.normal(size=(40, 16)).astype(np.float32)
    data[9], data[8] = data[3], data[4]
    q = (data[3] + 0.01).astype(np.float32)[None].repeat(2, 0)
    cand = np.array([[9, 1, 3, 2, 8, 4, 5, 6, 7, 0, 11, 12],
                     [3, 4, 9, 8, 1, 2, 5, 6, 7, 0, 11, 12]], np.int32)
    wv, wi = verify_topk_pallas(jnp.asarray(data), jnp.asarray(q),
                                jnp.asarray(cand), k, interpret=True)
    gv, gi = ops.verify_topk(_t(data), _t(q), _t(cand), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    assert gi.numpy()[0, 0] == 9 and gi.numpy()[1, 0] == 3


def test_verify_k_over_128_routes_to_plain():
    data, q, cand = _verify_inputs(2, 400, 8, 300, 0, seed=5)
    before = counts.ROUTES["verify_topk.k_over_128"]
    gv, gi = ops.verify_topk(_t(data), _t(q), _t(cand), 150)
    wv, wi = jref.verify_topk(data, q, cand, 150)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert counts.ROUTES["verify_topk.k_over_128"] == before + 1


# ---------------------------------------------------------------------------
# topk_smallest
# ---------------------------------------------------------------------------


def _topk_case(name):
    rng = np.random.default_rng(len(name))
    if name == "few_finite":  # one row with only two finite entries
        d = (rng.normal(size=(3, 700)) ** 2).astype(np.float32)
        d[0] = np.inf
        d[0, [5, 600]] = [2.0, 1.0]
        d[2, rng.permutation(700)[:500]] = np.inf
        return d, 4
    B, N, k = {"random": (5, 700, 10), "k_1": (3, 300, 1), "k_128": (2, 1000, 128),
               "k_equals_N": (2, 33, 33), "ties": (4, 600, 20),
               "all_equal": (3, 513, 16)}[name]
    if name == "ties":
        return rng.integers(0, 4, size=(B, N)).astype(np.float32), k
    if name == "all_equal":
        return np.full((B, N), 7.0, np.float32), k
    return (rng.normal(size=(B, N)) ** 2).astype(np.float32), k


TOPK_CASES = ["random", "k_1", "k_128", "k_equals_N", "ties", "all_equal", "few_finite"]


@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_matches_jax_oracle(name):
    """Values and indices everywhere, +inf entries included."""
    d, k = _topk_case(name)
    gv, gi = ops.topk_smallest(_t(d), k)
    wv, wi = jref.topk_smallest(d, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    if name == "few_finite":
        assert gi.numpy()[0].tolist() == [600, 5, 0, 1]


@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_matches_pallas(name):
    """Values everywhere; indices where the value is finite: for a row
    with fewer than k finite entries the TPU kernel repeats an index in
    the +inf slots, where the port answers the sort's."""
    d, k = _topk_case(name)
    gv, gi = ops.topk_smallest(_t(d), k)
    wv, wi = topk_smallest_pallas(jnp.asarray(d), k, interpret=True)
    wv, wi = np.asarray(wv), np.asarray(wi)
    np.testing.assert_array_equal(gv.numpy(), wv)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(gi.numpy()[finite], wi[finite])
    if name == "few_finite":
        assert wi[0].tolist() == [600, 5, 5, 5]  # the deviation the port does not copy


@pytest.mark.parametrize("B,N,k", [(3, 2000, 150), (2, 300, 200)])
def test_topk_k_over_128_takes_the_radius_select_route(B, N, k):
    d = (np.random.default_rng(N).normal(size=(B, N)) ** 2).astype(np.float32)
    wv, wi = jops.topk_smallest(jnp.asarray(d), k, force="interpret")
    before = dict(counts.ROUTES)
    gv, gi = ops.topk_smallest(_t(d), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert counts.ROUTES["topk_smallest.k_over_128"] == before["topk_smallest.k_over_128"] + 1
    sort = counts.ROUTES["radius_select.sort"] - before["radius_select.sort"]
    assert sort == (1 if k + 256 >= N else 0)


def test_topk_rejects_k_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        ops.topk_smallest(torch.zeros(2, 5), 6)
    with pytest.raises(ValueError, match="out of range"):
        ops.topk_smallest(torch.zeros(2, 5), 0)


# ---------------------------------------------------------------------------
# project_dist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,d,m", [(5, 700, 200, 15), (1, 1030, 130, 16), (7, 64, 33, 20)])
def test_project_dist_matches_pallas(B, N, d, m):
    """N not a multiple of the TPU kernel's 512-point tile, d not a
    multiple of its 128-wide slab."""
    rng = np.random.default_rng(B + N + d)
    x = rng.normal(size=(N, d)).astype(np.float32)
    a = rng.normal(size=(d, m)).astype(np.float32)
    qp = (rng.normal(size=(B, d)).astype(np.float32) @ a).astype(np.float32)
    got = ops.project_dist(_t(x), _t(a), _t(qp)).numpy()
    assert got.shape == (B, N) and got.dtype == np.float32
    proj = x.astype(np.float64) @ a.astype(np.float64)
    tol = 1e-5 * ((qp.astype(np.float64) ** 2).sum(1)[:, None] + (proj ** 2).sum(1)[None]) + 1e-6
    for want in (project_dist_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(qp),
                                     interpret=True),
                 jref.project_dist(x, a, qp)):
        assert (np.abs(got - np.asarray(want)) <= tol).all()
