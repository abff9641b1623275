"""The port's flat facade held against the JAX flat facade.

Both facades index the same ``make_clustered`` data with the same
projection: the port's is built from the JAX index's ``data``,
``family.a`` and ``projected`` through ``repro_torch.convert``, on
``device="cpu"``, where every kernel runs its plain PyTorch version.

On the JAX side ``force="ref"`` runs the jnp oracles and
``force="interpret"`` the Pallas kernels in interpret mode.  ids must be
identical.  Distances agree to rtol 1e-6: both facades recompute their
answers in the difference form (``answer_distances``), in float32 sums
of another order.  ``candidates_selected`` is compared where both sides
count the same thing: on the unfused path (the budget T) and against
the interpret-mode kernels (the survivors under the ladder's final
threshold); the jnp oracle of radius_select thresholds differently.
"""
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro_torch.core import ann_query, build_flat_index, candidate_budget
from repro_torch.index import FlatBackend, IndexConfig, build_index

D = 32


def _queries(data, B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, data.shape[0], B)
    return (data[ids] + 0.3 * rng.normal(size=(B, data.shape[1]))).astype(np.float32)


def _pair(data, jax_options, options=None):
    """(JAX facade, port facade on the CPU) over the same data and A."""
    ji = jax_build_index(data, JaxConfig(backend="flat", options=jax_options))
    ti = FlatBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected),
        IndexConfig(backend="flat", options=options or {}), device="cpu")
    return ji, ti


_REF_PAIRS = {}


def _ref_pair(n):
    if n not in _REF_PAIRS:
        _REF_PAIRS[n] = _pair(make_clustered(n, D, seed=n), {"force": "ref"})
    return _REF_PAIRS[n]


def _same(rj, rt):
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=1e-6)
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("n", [2048, 9000])  # both sides of the fused policy
def test_facade_matches_jax_ref(n, B, k):
    ji, ti = _ref_pair(n)
    q = _queries(ji.data, B, seed=n + B + k)
    rj, rt = ji.search(q, k), ti.search(q, k)
    _same(rj, rt)
    assert rt.stats.rounds == rj.stats.rounds == B
    assert rt.stats.candidates_verified == rj.stats.candidates_verified
    if n < 8192:  # the unfused rank cut selects exactly the budget T
        assert rt.stats.candidates_selected == rj.stats.candidates_selected


@pytest.mark.parametrize("fused", [True, False])
def test_full_budget_T_equals_n(fused):
    data = make_clustered(60, 8, n_clusters=4, seed=4)
    ji, ti = _pair(data, {"force": "ref", "fused": fused}, {"fused": fused})
    q = _queries(data, 3, seed=5)
    assert candidate_budget(ti.impl.params, 60, 60) == 60
    _same(ji.search(q, 60), ti.search(q, 60))


def test_k_greater_than_n_pads():
    data = make_clustered(20, 8, n_clusters=3, seed=6)
    ji, ti = _pair(data, {"force": "ref"})
    q = _queries(data, 2, seed=7)
    rj, rt = ji.search(q, 32), ti.search(q, 32)
    _same(rj, rt)
    assert (rt.indices[:, 20:] == -1).all() and np.isinf(rt.distances[:, 20:]).all()


@pytest.mark.parametrize("n", [2048, 9000])
def test_non_finite_query_rows(n):
    ji, ti = _ref_pair(n)
    q = _queries(ji.data, 5, seed=8)
    q[1, 3] = np.nan
    q[4, 0] = np.inf
    rj, rt = ji.search(q, 10), ti.search(q, 10)
    _same(rj, rt)
    assert (rt.indices[[1, 4]] == -1).all()
    assert rt.stats.queries_rejected == rj.stats.queries_rejected == 2


@pytest.mark.parametrize("B,k", [(1, 1), (7, 10)])
def test_fused_facade_matches_jax_interpret(B, k):
    """The JAX side runs the Pallas kernels themselves (interpret mode)."""
    data = make_clustered(1024, D, seed=11)
    ji, ti = _pair(data, {"fused": True, "force": "interpret"}, {"fused": True})
    q = _queries(data, B, seed=12 + B)
    rj, rt = ji.search(q, k), ti.search(q, k)
    _same(rj, rt)
    assert rt.stats.candidates_selected == rj.stats.candidates_selected
    np.testing.assert_array_equal(ti.last_select_counts, ji.last_select_counts)


def test_unfused_facade_matches_jax_interpret():
    data = make_clustered(1024, D, seed=13)
    ji, ti = _pair(data, {"fused": False, "force": "interpret"}, {"fused": False})
    q = _queries(data, 7, seed=14)
    _same(ji.search(q, 10), ti.search(q, 10))


def test_from_arrays_without_projected_agrees():
    """convert computes data @ A itself when ``projected`` is not given."""
    ji, ti = _ref_pair(2048)
    own = FlatBackend.from_arrays(ji.data, np.asarray(ji.impl.family.a),
                                  device="cpu")
    q = _queries(ji.data, 7, seed=15)
    np.testing.assert_array_equal(own.search(q, 10).indices, ti.search(q, 10).indices)


def test_fused_and_unfused_agree_in_the_port():
    data = make_clustered(400, 24, seed=16)
    index = build_flat_index(data, m=15, device="cpu")
    q = torch.from_numpy(_queries(data, 8, seed=17))
    for k in (1, 10):
        T = candidate_budget(index.params, 400, k)
        i0, d0 = ann_query(index, q, k=k, T=T, fused=False)
        i1, d1 = ann_query(index, q, k=k, T=T, fused=True)
        assert torch.equal(i0, i1)
        torch.testing.assert_close(d0, d1, rtol=1e-5, atol=1e-5)


def test_build_index_on_cpu_answers_well():
    """The port's own projection draw (a torch.Generator) on the CPU."""
    data = make_clustered(3000, D, seed=18)
    index = build_index(data, IndexConfig(backend="flat"), device="cpu")
    q = _queries(data, 16, seed=19)
    res = index.search(q, 10)
    exact = np.argsort(((q[:, None, :] - data[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(res.indices[i]) & set(exact[i])) / 10 for i in range(16)])
    assert res.indices.shape == (16, 10) and recall > 0.8


def test_port_registers_every_reference_backend():
    """Every backend of the reference is registered in the port, in the
    reference's order, with the reference's capabilities."""
    from repro.index import available_backends as jax_available
    from repro.index import backend_capabilities as jax_capabilities
    from repro_torch.index import available_backends, backend_capabilities

    assert available_backends() == jax_available()
    for name in jax_available():
        assert backend_capabilities(name) == jax_capabilities(name), name
    for cap in ("ann", "cp", "quant", "stream"):
        assert available_backends(cap) == jax_available(cap), cap


@pytest.mark.parametrize("options,force", [
    ({"use_kernels": False}, "plain"),
    ({"use_kernels": True}, None),
    ({}, None),
    ({"use_kernels": False, "quant": "sq8"}, "plain"),
])
def test_use_kernels_option_sets_the_dispatch(monkeypatch, options, force):
    """``use_kernels=False`` selects the plain versions, as the reference
    maps it to force="ref" (repro/index/backends.py:305-307): every
    dispatch the search makes carries force="plain", which on the card
    launches no kernel."""
    from repro_torch.kernels import ops

    seen = []
    real = ops._plain

    def spy(f, *tensors):
        seen.append(f)
        return real(f, *tensors)

    monkeypatch.setattr(ops, "_plain", spy)
    data = make_clustered(9000, 16, seed=24)
    index = build_index(data, IndexConfig(backend="flat", options=options), device="cpu")
    assert index.force == force
    index.search(_queries(data, 3, seed=25), 10)
    index.cp_search(5)
    assert seen and set(seen) == {force}


@pytest.mark.parametrize("n,fused", [(2048, False), (9000, True)])
def test_last_select_budget_matches_jax(n, fused):
    """The drift monitor reads (last_select_counts, last_select_budget)
    off a flat segment: both equal the JAX backend's after a search."""
    data = make_clustered(n, D, seed=26)
    ji, ti = _pair(data, {"fused": fused, "force": "interpret" if fused else "ref"},
                   {"fused": fused})
    q = _queries(data, 5, seed=27)
    _same(ji.search(q, 10), ti.search(q, 10))
    assert ti.last_select_budget == ji.last_select_budget == candidate_budget(
        ti.impl.params, n, 10)
    np.testing.assert_array_equal(ti.last_select_counts, ji.last_select_counts)


@pytest.mark.parametrize("call", ["search", "cp_search"])
def test_facade_span_roots_match_jax(call):
    """Traced, the port's facade opens the reference's root span with its
    attrs: ``index.search`` (backend, B, k and the batch's WorkStats as
    ``work``) and ``index.cp_search`` (backend, k, work), and below it
    the reference's whole tree: the ``ann.query`` span of the unfused
    pipeline, or ``cp.*`` with the ``kernel.pair_join`` span and its
    modeled bytes and FLOPs."""
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace

    x = np.random.default_rng(0).standard_normal((2000, 16)).astype(np.float32)
    ji, ti = _pair(x, {"force": "ref"})
    q = _queries(x, 3, seed=1)
    run = (lambda index: index.search(q, 5)) if call == "search" else (
        lambda index: index.cp_search(5))
    with jtrace.trace() as jtr:
        run(ji)
    with trace.trace() as ttr:
        res = run(ti)
    spans = trace.reference_view(ttr)
    assert [(s.name, s.parent, s.attrs.get("bytes"), s.attrs.get("flops"))
            for s in spans] == [(s.name, s.parent, s.attrs.get("bytes"),
                                 s.attrs.get("flops")) for s in jtr.spans]
    assert len(spans) > 1
    jroots = [s for s in jtr.spans if s.parent == -1]
    troots = [s for s in spans if s.parent == -1]
    assert [s.name for s in troots] == [s.name for s in jroots] == ["index." + call]
    jattrs, tattrs = jroots[0].attrs, troots[0].attrs
    assert sorted(tattrs) == sorted(jattrs)
    assert {k: v for k, v in tattrs.items() if k != "work"} == {
        k: v for k, v in jattrs.items() if k != "work"}
    assert tattrs["work"] == res.stats.as_dict()
    assert sorted(tattrs["work"]) == sorted(jattrs["work"])
    assert not trace.enabled()
