"""The port's nine §7 baselines, through its facade, held against the JAX
package's on the same data.

Where the reference draws with ``jax.random`` (Multi-Probe's and the
LSB-tree's bucket families, SRS's and R-LSH's projection), the port's
index takes the JAX index's draws through ``options`` (``families``,
``a`` and ``projected``); the rest draw with numpy's ``default_rng`` in
both packages.  Ids and work must be identical; distances agree to rtol
1e-5 (the same numpy in both packages, but a projected query may differ
in its last bit between XLA and torch, which on these inputs moves no
candidate).
"""
import numpy as np
import pytest

from conftest import make_clustered
from repro.index import IndexConfig as JaxConfig
from repro.index import available_backends as jax_available
from repro.index import backend_capabilities as jax_capabilities
from repro.index import build_index as jax_build_index
from repro_torch.convert import bucket_families_from_arrays
from repro_torch.index import (
    IndexConfig,
    available_backends,
    backend_capabilities,
    build_index,
)

ANN = ["lscan", "multiprobe", "qalsh", "srs", "rlsh", "lsb_tree"]
CP = ["lsb_tree", "acp_p", "mkcp", "nlj"]


@pytest.fixture(scope="module")
def data():
    return make_clustered(1200, 32, n_clusters=15, seed=0)


@pytest.fixture(scope="module")
def queries(data):
    rng = np.random.default_rng(1)
    return (data[rng.integers(0, len(data), 5)] + 0.05).astype(np.float32)


def _given_draws(name, jax_impl) -> dict:
    """The JAX index's random draws, as the port's options take them."""
    if name == "multiprobe":
        fams = [f for f, _ in jax_impl.tables]
    elif name == "lsb_tree":
        fams = [t[0] for t in jax_impl.trees]
    elif name in ("srs", "rlsh"):
        return {"a": np.asarray(jax_impl.fam.a), "projected": np.asarray(jax_impl.proj)}
    else:
        return {}
    return {"families": bucket_families_from_arrays(
        [(np.asarray(f.a), np.asarray(f.b), f.w) for f in fams], device="cpu")}


def _pair(name, data):
    ji = jax_build_index(data, JaxConfig(backend=name))
    ti = build_index(data, IndexConfig(backend=name,
                                       options=_given_draws(name, ji.impl)), device="cpu")
    return ji, ti


@pytest.mark.parametrize("name", ANN)
def test_ann_baseline_matches_jax(name, data, queries):
    ji, ti = _pair(name, data)
    rj, rt = ji.search(queries, 10), ti.search(queries, 10)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    # the contract: (B, k), real distances ascending, -1 / +inf padding
    found = rt.indices >= 0
    assert rt.indices.shape == (5, 10) and found[:, 0].all()
    assert (found[:, :-1] >= found[:, 1:]).all() and np.isinf(rt.distances[~found]).all()
    assert all((np.diff(dd[f]) >= 0).all() for dd, f in zip(rt.distances, found))
    true = np.linalg.norm(data[rt.indices[found]] - np.repeat(queries, 10, 0)[found.ravel()],
                          axis=-1)
    np.testing.assert_allclose(rt.distances[found], true, rtol=1e-4)


@pytest.mark.parametrize("name", CP)
def test_cp_baseline_matches_jax(name, data):
    ji, ti = _pair(name, data[:400])
    rj, rt = ji.cp_search(5), ti.cp_search(5)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-5)
    assert rt.stats.as_dict() == rj.stats.as_dict()
    assert rt.pairs.shape == (5, 2) and (rt.pairs[:, 0] != rt.pairs[:, 1]).all()


def test_registry_matches_jax_where_both_register():
    names = available_backends()
    assert names == ["pmtree", "flat", "flat-pq", "sharded", "sharded-flat",
                     "sharded-flat-pq", "multiprobe", "qalsh", "srs", "rlsh",
                     "lscan", "lsb_tree", "acp_p", "mkcp", "nlj", "streaming"]
    jax_names = jax_available()
    assert [n for n in jax_names if n in names] == names
    for name in names:
        assert backend_capabilities(name) == jax_capabilities(name), name


def test_own_draws_answer_well(data, queries):
    """Multi-Probe and SRS with the port's own draws (torch.Generator)."""
    exact = np.argsort(((queries[:, None, :] - data[None]) ** 2).sum(-1), axis=1)[:, :10]
    for name in ("multiprobe", "srs"):
        res = build_index(data, IndexConfig(backend=name), device="cpu").search(queries, 10)
        recall = np.mean([len(set(res.indices[i]) & set(exact[i])) / 10
                          for i in range(len(queries))])
        assert recall > 0.2, (name, recall)


def test_given_families_must_match_the_table_count(data):
    fams = bucket_families_from_arrays(
        [(np.ones((32, 6), np.float32), np.zeros(6, np.float32), 4.0)], device="cpu")
    with pytest.raises(ValueError, match="1 families for 4 tables"):
        build_index(data, IndexConfig(backend="multiprobe", options={"families": fams}),
                    device="cpu")
