"""Storage accounting (``bytes_per_point`` / ``raw_bytes_per_point``) of
the port's indexes held against the JAX package's on the same data and
the same configuration: the values are byte counts from shapes, so they
must be equal exactly."""
import numpy as np
import pytest

from conftest import make_clustered
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro_torch.index import IndexConfig, build_index

D = 24


@pytest.fixture(scope="module")
def data():
    return make_clustered(900, D, seed=31)


@pytest.mark.parametrize("backend,options", [
    ("flat", {}),
    ("flat", {"quant": "sq8"}),
    ("flat", {"quant": "sq8", "store_raw": False}),
    ("flat-pq", {}),
    ("flat-pq", {"store_raw": False}),
    ("flat-pq", {"pq": {"m_codebooks": 6, "n_centroids": 32}}),
    ("pmtree", {}),
    ("lscan", {}),
])
def test_static_index_bytes_match_jax(data, backend, options):
    ji = jax_build_index(data, JaxConfig(backend=backend, options=options))
    ti = build_index(data, IndexConfig(backend=backend, options=options), device="cpu")
    assert ti.bytes_per_point() == ji.bytes_per_point()
    assert ti.raw_bytes_per_point() == ji.raw_bytes_per_point()
    if options.get("store_raw") is False:
        assert ti.raw_bytes_per_point() == 0.0 < ti.bytes_per_point() < 4.0 * D


@pytest.mark.parametrize("options", [
    {},
    {"segment_backend": "flat-pq"},
    {"quant": "sq8"},
])
def test_churned_stream_bytes_match_jax(data, options):
    opts = {"delta_threshold": 200, "max_segments": 3, **options}
    ji = jax_build_index(data[:400], JaxConfig(backend="streaming", options=opts))
    ti = build_index(data[:400], IndexConfig(backend="streaming", options=opts),
                     device="cpu")
    rng = np.random.default_rng(5)
    deltas = []
    for lo in range(400, 900, 125):
        np.testing.assert_array_equal(ti.insert(data[lo:lo + 125]),
                                      ji.insert(data[lo:lo + 125]))
        kill = rng.choice(ji.live_ids(), 20, replace=False)
        assert ti.delete(kill) == ji.delete(kill)
        assert ti.bytes_per_point() == pytest.approx(ji.bytes_per_point(), rel=1e-12)
        assert ti.raw_bytes_per_point() == pytest.approx(ji.raw_bytes_per_point(), rel=1e-12)
        deltas.append(ti.delta_size)
    assert ti.segment_count == ji.segment_count >= 2 and max(deltas) > 0
    assert ti.n_compactions == ji.n_compactions >= 1
    assert ti.raw_bytes_per_point() > 4.0 * D  # tombstoned rows stay in the store


def test_empty_stream_counts_zero():
    ti = build_index(np.empty((0, D), np.float32), IndexConfig(backend="streaming"),
                     device="cpu")
    assert ti.bytes_per_point() == ti.raw_bytes_per_point() == 0.0
