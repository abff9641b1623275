"""The plain reference against a float64 brute force of the same PM-LSH
semantics written in numpy, and its frozen copies against the program."""
import math

import numpy as np
import pytest
import torch

from bench.lib import data
from bench.reference import pmlsh


def _twin(n, d, clusters=6, active=3, seed=5, mixture_seed=1):
    return data.clustered_twin(n, d, clusters, active, mixture_seed, seed, torch.device("cpu"))


def test_twin_rows_come_from_the_seed_and_the_mixture_from_the_configuration():
    a, again = _twin(400, 8, seed=2 ** 31 + 5), _twin(400, 8, seed=2 ** 31 + 5)
    other = _twin(400, 8, seed=6)
    assert torch.equal(a, again) and not torch.allclose(a, other)
    # every seed's rows lie near the centres of the one mixture (its spread
    # along 3 directions, a few units), which lie tens of units apart
    gen = data.generator(1, "mixture", torch.device("cpu"))
    centres = torch.randn((6, 8), generator=gen) * data.CENTER_SCALE
    for rows in (a, other):
        assert float(torch.cdist(rows, centres).min(1).values.max()) < 6.0


def _brute_ann(x, a, q, k, T):
    """PM-LSH in numpy float64: the T smallest estimates, the k nearest of them."""
    x, a, q = (np.asarray(v, np.float64) for v in (x, a, q))
    est = (((x @ a)[None, :, :] - (q @ a)[:, None, :]) ** 2).sum(-1)
    cand = np.argsort(est, axis=1, kind="stable")[:, :T]
    d2 = ((x[cand] - q[:, None, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(cand, order, 1), np.sqrt(np.take_along_axis(d2, order, 1))


@pytest.mark.parametrize("n,d,k", [(600, 16, 5), (1500, 24, 10)])
def test_ann_reference_matches_brute_force(n, d, k):
    x = _twin(n, d)
    q = data.jittered_queries(x, 12, seed=9)
    a = pmlsh.projection_from_seed(d, 15, 3)
    ref = pmlsh.AnnReference(x, a, c=1.5)
    T = ref.budget(k)
    ids, dist = ref.answer(q, k)
    want_ids, want_dist = _brute_ann(x.numpy(), a.numpy(), q.numpy(), k, T)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(dist.numpy(), want_dist, rtol=1e-12)
    np.testing.assert_allclose(ref.distances(q, ids).numpy(), want_dist, rtol=1e-12)


def test_cp_reference_matches_brute_force():
    x = _twin(400, 12)
    ref = pmlsh.CpReference(x, pmlsh.projection_from_seed(12, 15, 1)[:, 0])
    pairs, dist = ref.nearest(25)
    xx = x.numpy().astype(np.float64)
    d = np.sqrt(((xx[:, None, :] - xx[None, :, :]) ** 2).sum(-1))
    i, j = np.triu_indices(len(xx), 1)
    order = np.lexsort((j, i, d[i, j]))[:25]
    np.testing.assert_array_equal(pairs.numpy(), np.stack([i[order], j[order]], 1))
    np.testing.assert_allclose(dist.numpy(), d[i, j][order], rtol=1e-12)
    # the filter's count: pairs whose key gap is within reach of D
    D = float(dist[-1])
    key = xx @ pmlsh.projection_from_seed(12, 15, 1)[:, 0].numpy().astype(np.float64)
    gaps = np.abs(key[i] - key[j])
    assert ref.filter_pairs(D) == int((gaps <= ref.reach * D).sum())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -3.14159, 6.0e-3], dtype=torch.float32)
    r = pmlsh.to_tf32(x)
    bits = r.view(torch.int32).to(torch.int64) & 0x1FFF
    assert int(bits.abs().sum()) == 0  # 13 low mantissa bits cleared
    # ties to even: 1 + 2^-11 -> 1; 1 + 3 * 2^-11 -> 1 + 2^-9
    assert r[1].item() == 1.0 and r[3].item() == 1.0 + 2 ** -9
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -11)


def test_control_differs_from_reference():
    x = _twin(1500, 24)
    q = data.jittered_queries(x, 8, seed=2)
    a = pmlsh.projection_from_seed(24, 15, 3)
    ids, dist = pmlsh.AnnReference(x, a, precision="tf32").answer(q, 10)
    exact = pmlsh.AnnReference(x, a).distances(q, ids)
    assert float(((dist.double() - exact).abs() / exact).max()) > 1e-3


@pytest.mark.parametrize("c,m", [(1.5, 15), (4.0, 15), (2.0, 8)])
def test_frozen_solve_agrees_with_the_program(c, m):
    from repro_torch.core.estimator import solve_parameters
    from repro_torch.core.flat_index import candidate_budget

    beta, t = pmlsh.solve(c, m)
    p = solve_parameters(c, m=m)
    assert math.isclose(beta, p.beta, rel_tol=1e-12) and math.isclose(t, p.t, rel_tol=1e-12)
    for n, k in [(1_000_000, 10), (1_000_000, 16), (54_387, 10)]:
        assert pmlsh.budget(beta, n, k) == candidate_budget(p, n, k)


def test_frozen_budgets():
    beta, _ = pmlsh.solve(1.5, 15)
    assert round(beta, 5) == 0.09669
    assert pmlsh.budget(beta, 1_000_000, 10) == 96_704  # ceil(beta n) + k


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_frozen_projection_agrees_with_the_program(seed):
    from repro_torch.core.hashing import ProjectionFamily

    a = pmlsh.projection_from_seed(256, 15, seed)
    b = ProjectionFamily.from_seed(256, 15, seed, device="cpu").a
    assert torch.equal(a, b)


def test_twin_is_seeded_and_clustered():
    a, b = _twin(500, 16), _twin(500, 16)
    assert torch.equal(a, b) and not torch.equal(a, _twin(500, 16, seed=6))
    q = data.jittered_queries(a, 40, seed=1)
    assert q.shape == (40, 16)
    nearest = torch.cdist(q, a).min(1).values
    assert float(nearest.max()) < float(torch.cdist(a[:50], a[50:100]).median())
    order = data.fixed_order([10, 20, 50, 100], 64, seed=3, tag="k")
    assert sorted(order.tolist()) == sorted([10, 20, 50, 100] * 16)
    assert data.sub_seed(2 ** 33, "x") == data.sub_seed(2 ** 33, "x") < 2 ** 63
