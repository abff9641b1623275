"""The port's closest-pair path held against the JAX package's.

Three layers, on the same numpy inputs made from a seed:

  kernel   the port's ``ref.pair_join`` (through ``ops``, CPU tensors)
           against the JAX numpy oracle ``repro.kernels.ref.pair_join``
           and the Pallas kernel in interpret mode, on the cases of
           ``tests/test_cp_fused.py``;
  engine   ``repro_torch.core.cp_fused.cp_fused_search`` against
           ``repro.core.cp_fused.cp_fused_search`` with the same key;
  facade   the port's ``flat`` ``cp_search`` (``from_arrays`` on
           ``device="cpu"``) against the JAX facade with
           ``force="interpret"`` or ``force="ref"``.

Tolerances: pair positions, pairs and counters are identical; the
join's d² agree to rtol 1e-4, atol 1e-5 (norm-trick cross terms summed
by BLAS in another order than XLA's, as ``test_cp_fused.py`` allows
between the oracle and the kernel); reported distances, recomputed in
the difference form on both sides, agree to rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_clustered
from repro.core.cp_fused import cp_fused_search as jax_cp_fused_search
from repro.core.cp_fused import cp_threshold2 as jax_cp_threshold2
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pair_join import pair_join_pallas
from repro_torch.core.cp_fused import cp_fused_search, cp_threshold2
from repro_torch.index import FlatBackend, IndexConfig, build_index
from repro_torch.kernels import counts, ops

D2_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sorted(x, seed):
    rng = np.random.default_rng(seed)
    key = x @ rng.normal(size=(x.shape[1],)).astype(np.float32)
    order = np.argsort(key, kind="stable")
    return x[order], key[order].astype(np.float32)


def _join(xs, ks, k, thresh2):
    """The port's plain join on CPU tensors, as numpy."""
    v, pi, pj, stats = ops.pair_join(_t(xs), _t(ks), k, thresh2=thresh2)
    return v.numpy(), pi.numpy(), pj.numpy(), stats.numpy()


def _same_join(got, want):
    v, pi, pj, stats = got
    wv, wi, wj, ws = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(pi, wi)
    np.testing.assert_array_equal(pj, wj)
    np.testing.assert_allclose(v, wv, **D2_TOL)
    np.testing.assert_array_equal(stats[:2], ws[:2])
    assert v.dtype == np.float32 and pi.dtype == np.int32 and stats.dtype == np.int64


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k,thresh2", [
    (64, 8, 5, np.inf),     # single tile, pruning disabled
    (100, 12, 1, 9.0),      # partial tile, k = 1
    (300, 16, 10, 16.0),    # several tiles, live pruning threshold
    (513, 24, 16, 16.0),    # ragged last block
])
def test_pair_join_matches_oracle_and_interpret(n, d, k, thresh2):
    rng = np.random.default_rng(n + k)
    xs, ks = _sorted(rng.normal(size=(n, d)).astype(np.float32), n)
    got = _join(xs, ks, k, thresh2)
    _same_join(got, jref.pair_join(xs, ks, k, thresh2=thresh2))
    _same_join(got, pair_join_pallas(jnp.asarray(xs), jnp.asarray(ks), k,
                                     thresh2=float(thresh2), interpret=True))


def test_pair_join_two_far_clusters_prunes_like_the_oracle():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=(256, 8)),
                        rng.normal(size=(256, 8)) + 500.0]).astype(np.float32)
    order = np.argsort(x[:, 0], kind="stable")
    xs, ks = x[order], x[order, 0].copy()
    got = _join(xs, ks, 10, 16.0)
    _same_join(got, jref.pair_join(xs, ks, 10, thresh2=16.0))
    assert got[3][1] > 0, "cross-cluster tiles must be pruned"
    full = _join(xs, ks, 10, np.inf)
    np.testing.assert_allclose(got[0], full[0], rtol=1e-5)
    assert got[3][2] < full[3][2]  # fewer bands joined than the full sweep


def test_pair_join_fewer_pairs_than_k_pads():
    x = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    order = np.argsort(x[:, 0], kind="stable")
    xs, ks = x[order], x[order, 0].copy()
    got = _join(xs, ks, 10, np.inf)
    _same_join(got, jref.pair_join(xs, ks, 10, thresh2=np.inf))
    v, pi, pj, stats = got
    assert np.isfinite(v[:6]).all() and np.isinf(v[6:]).all()
    assert (pi[6:] == -1).all() and (pj[6:] == -1).all()
    assert stats.tolist() == [6, 0, 1]


def test_pair_join_k_over_128_takes_the_plain_route():
    xs, ks = _sorted(np.random.default_rng(9).normal(size=(40, 6)).astype(np.float32), 9)
    before = counts.ROUTES["pair_join.k_over_128"]
    got = _join(xs, ks, 200, np.inf)
    assert counts.ROUTES["pair_join.k_over_128"] == before + 1
    _same_join(got, jops.pair_join(xs, ks, 200, thresh2=np.inf, force="interpret"))
    assert np.isfinite(got[0][:40 * 39 // 2]).all() and np.isinf(got[0][780:]).all()


@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("c,m", [(4.0, 15), (2.0, 10)])
def test_cp_threshold2_matches_jax(c, m, gamma):
    assert cp_threshold2(c, m, gamma) == pytest.approx(jax_cp_threshold2(c, m, gamma),
                                                       rel=1e-12)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("k", [1, 10])
def test_engine_matches_jax_engine(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    key = (x @ rng.normal(size=(24,)).astype(np.float32)).astype(np.float32)
    want = jax_cp_fused_search(x, k, force="ref", key=key)
    got = cp_fused_search(x, k, key=_t(key), device="cpu")
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-6)
    assert (got.pairs_verified, got.tiles_pruned) == (want.pairs_verified,
                                                      want.tiles_pruned)
    assert got.pairs.dtype == np.int32 and got.distances.dtype == np.float32


def test_engine_duplicates_answer_zero_distances():
    """Exact duplicates are where the norm trick cancels: the re-verify
    in the difference form reports them at exactly 0.  Which 10 of the
    50 duplicate pairs win depends on the cancellation's rounding, so
    only their kind is compared."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 16)).astype(np.float32)
    x[150:] = x[:50]
    key = (x @ rng.normal(size=(16,)).astype(np.float32)).astype(np.float32)
    got = cp_fused_search(x, 10, key=_t(key), device="cpu")
    want = jax_cp_fused_search(x, 10, force="ref", key=key)
    assert (got.distances == 0).all() and (want.distances == 0).all()
    assert (got.pairs[:, 1] - got.pairs[:, 0] == 150).all()
    assert len({tuple(p) for p in got.pairs.tolist()}) == 10


def test_engine_k_beyond_pair_count_and_single_point():
    x = np.random.default_rng(6).normal(size=(5, 4)).astype(np.float32)
    got = cp_fused_search(x, 50, device="cpu")
    assert got.pairs.shape == (10, 2) and np.all(np.diff(got.distances) >= 0)
    one = cp_fused_search(x[:1], 3, device="cpu")
    assert one.pairs.shape == (0, 2) and one.pairs_verified == 0
    with pytest.raises(ValueError, match="k must be >= 1"):
        cp_fused_search(x, 0, device="cpu")


# ---------------------------------------------------------------------------
# facade level
# ---------------------------------------------------------------------------


def _flat_pair(data, force, options=None):
    ji = jax_build_index(data, JaxConfig(backend="flat",
                                         options={"force": force, **(options or {})}))
    ti = FlatBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected),
        IndexConfig(backend="flat", options=options or {}), device="cpu")
    return ji, ti


def _same_cp(rj, rt):
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-6)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    assert rt.pairs.dtype == np.int32 and rt.distances.dtype == np.float32


@pytest.mark.parametrize("n,force", [(1024, "interpret"), (2048, "ref"), (9000, "ref")])
@pytest.mark.parametrize("k", [1, 10])
def test_flat_cp_search_matches_jax(n, force, k):
    ji, ti = _flat_pair(make_clustered(n, 32, seed=n), force)
    rj, rt = ji.cp_search(k), ti.cp_search(k)
    _same_cp(rj, rt)
    assert rt.stats.tiles_pruned > 0 and rt.stats.pairs_verified > 0


@pytest.mark.parametrize("gamma", [0.5, 3.0])
def test_flat_cp_gamma_option(gamma):
    ji, ti = _flat_pair(make_clustered(1500, 16, seed=21), "ref", {"cp_gamma": gamma})
    _same_cp(ji.cp_search(10), ti.cp_search(10))


def test_flat_cp_k_beyond_pair_count():
    data = make_clustered(12, 8, n_clusters=3, seed=22)
    ji, ti = _flat_pair(data, "ref")
    rj, rt = ji.cp_search(100), ti.cp_search(100)
    _same_cp(rj, rt)
    assert rt.pairs.shape == (66, 2)


def test_build_index_cp_search_on_cpu_finds_the_exact_pairs():
    """The port's own projection draw: CP with a wide filter is exact."""
    data = make_clustered(900, 16, seed=23)
    index = build_index(data, IndexConfig(backend="flat", options={"cp_gamma": 4.0}),
                        device="cpu")
    res = index.cp_search(10)
    d = np.linalg.norm(data[:, None].astype(np.float64) - data[None], axis=-1)
    iu = np.triu_indices(900, 1)
    order = np.argsort(d[iu], kind="stable")[:10]
    exact = {(int(iu[0][o]), int(iu[1][o])) for o in order}
    assert {tuple(p) for p in res.pairs.tolist()} == exact
    assert (res.pairs[:, 0] < res.pairs[:, 1]).all()
