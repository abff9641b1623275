"""The port's quantized path held against the JAX package's.

On the same numpy inputs made from a seed:

  kernel   the port's ``ref.adc_dist`` (through ``ops``, CPU tensors)
           against the Pallas ADC kernel in interpret mode and the JAX
           oracle, with codes shared by the batch and per query;
  codecs   ``train_sq8`` / ``train_pq`` against the JAX trainers at the
           same seed (numpy both sides: bit-identical), and the codecs'
           encode / decode / lookup tables / direct ADC;
  facade   ``flat`` with ``options={"quant": ...}`` and ``flat-pq``,
           the port's ``from_arrays`` on ``device="cpu"`` given the JAX
           index's projection, codec and codes, against the JAX facade
           with ``force="interpret"`` or ``force="ref"``: ``search`` and
           ``cp_search``, SQ8, PQ and ``store_raw=False``, n on both
           sides of the fused policy's 8192.

Tolerances: ids, pairs, codes, trained arrays and WorkStats identical;
ADC sums to rtol 1e-6 (the same table entries added in another order:
slot order here, 8-slot blocks in the Pallas kernel); tables and
decoded rows to rtol 1e-6 (float32 sums of ds squared differences in
another order); answer distances to rtol 1e-6, except against the
interpret-mode verify kernel on the fused path: the quantized path
answers with the verify tier's distances, which the TPU kernel forms by
the norm trick and the port in the difference form, so there they agree
to rtol 1e-4.  ``candidates_selected`` is compared where both sides
count the same thing, as in ``test_torch_flat.py``: on the unfused path
and against the interpret-mode select kernel (the JAX select oracle
thresholds differently).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_clustered
from repro.index import IndexConfig as JaxConfig
from repro.index import build_index as jax_build_index
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.adc import adc_dist_pallas
from repro.quant import train_pq as jax_train_pq
from repro.quant import train_sq8 as jax_train_sq8
from repro_torch.convert import codec_from_arrays
from repro_torch.index import (
    FlatBackend,
    FlatPQBackend,
    IndexConfig,
    available_backends,
    backend_capabilities,
    build_index,
)
from repro_torch.kernels import counts, ops
from repro_torch.quant import quant_ann_query, train_codec, train_pq, train_sq8

D = 32
RTOL = dict(rtol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _queries(data, B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, data.shape[0], B)
    return (data[ids] + 0.3 * rng.normal(size=(B, data.shape[1]))).astype(np.float32)


# ---------------------------------------------------------------------------
# the ADC kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,S,V", [(1, 213, 16, 256), (7, 300, 8, 256), (3, 77, 9, 32)])
def test_adc_shared_codes_matches_pallas(B, N, S, V):
    rng = np.random.default_rng(B + N + S)
    codes = rng.integers(0, V, size=(N, S)).astype(np.uint8)
    lut = (rng.normal(size=(B, S, V)) ** 2).astype(np.float32)
    got = ops.adc_dist(_t(codes), _t(lut)).numpy()
    assert got.shape == (B, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(adc_dist_pallas(codes, lut, interpret=True)),
                               **RTOL)
    np.testing.assert_allclose(got, np.asarray(jref.adc_dist(codes, lut)), **RTOL)


@pytest.mark.parametrize("B,N,S,V", [(1, 77, 9, 32), (7, 150, 16, 256)])
def test_adc_per_query_codes_matches_pallas(B, N, S, V):
    rng = np.random.default_rng(50 + B)
    codes = rng.integers(0, V, size=(B, N, S)).astype(np.uint8)
    lut = (rng.normal(size=(B, S, V)) ** 2).astype(np.float32)
    got = ops.adc_dist(_t(codes), _t(lut)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.adc_dist(jnp.asarray(codes), jnp.asarray(lut),
                                      force="interpret")), **RTOL)
    np.testing.assert_allclose(got, np.asarray(jref.adc_dist(codes, lut)), **RTOL)


def test_adc_sums_in_slot_order():
    """The plain version adds slot 0, 1, … from 0, as the kernel does."""
    lut = torch.tensor([[[1e8, 0.0], [1.0, 0.0], [-1e8, 0.0]]], dtype=torch.float32)
    codes = torch.zeros((1, 3), dtype=torch.uint8)
    # float32: (1e8 + 1) rounds to 1e8, so slot order gives 0; adding the
    # two large entries first would give 1
    assert ops.adc_dist(codes, lut).item() == 0.0


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset():
    return make_clustered(1500, D, n_clusters=20, seed=0)


def test_train_sq8_bit_identical(dataset):
    want = jax_train_sq8(dataset)
    got = train_sq8(dataset, device="cpu")
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))
    np.testing.assert_array_equal(got.encode(dataset).numpy(),
                                  np.asarray(want.encode(dataset)))


@pytest.mark.parametrize("m_codebooks,n_values,seed", [(16, 256, 0), (8, 64, 3), (5, 256, 1)])
def test_train_pq_bit_identical(dataset, m_codebooks, n_values, seed):
    """numpy k-means with default_rng(seed) on both sides; d = 32 does
    not divide by 5, so that case pads the last subspace."""
    want = jax_train_pq(dataset, m_codebooks=m_codebooks, n_values=n_values, seed=seed)
    got = train_pq(dataset, m_codebooks=m_codebooks, n_values=n_values, seed=seed,
                   device="cpu")
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    assert got.d == want.d
    np.testing.assert_array_equal(got.encode(dataset).numpy(),
                                  np.asarray(want.encode(dataset)))


def test_pq_sampled_training_and_clamped_values():
    x = make_clustered(300, 12, seed=4)
    want = jax_train_pq(x, m_codebooks=4, n_values=512, sample=200, seed=2)
    got = train_pq(x, m_codebooks=4, n_values=512, sample=200, seed=2, device="cpu")
    assert got.n_values == 150  # min(512, n // 2, 256) for n = 300
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))


@pytest.mark.parametrize("name", ["sq8", "pq"])
def test_codec_tables_decode_and_direct_adc(dataset, name):
    want = (jax_train_sq8(dataset) if name == "sq8"
            else jax_train_pq(dataset, m_codebooks=8, seed=0))
    got = train_codec(name, dataset, seed=0, device="cpu",
                      **({} if name == "sq8" else {"m_codebooks": 8}))
    q = _queries(dataset, 5, seed=9)
    codes = np.asarray(want.encode(dataset[:200]))
    np.testing.assert_allclose(got.lookup_tables(q).numpy(),
                               np.asarray(want.lookup_tables(q)), **RTOL)
    np.testing.assert_allclose(got.decode(_t(codes)).numpy(),
                               np.asarray(want.decode(codes)), **RTOL)
    if name == "sq8":
        cc = np.broadcast_to(codes[None], (5,) + codes.shape)
        np.testing.assert_allclose(got.adc_direct(_t(q), _t(cc)).numpy(),
                                   np.asarray(want.adc_direct(q, cc)), rtol=1e-5)


def test_unknown_codec_name(dataset):
    with pytest.raises(KeyError, match="unknown codec"):
        train_codec("opq", dataset, device="cpu")


def test_codec_from_arrays_checks_its_arrays():
    with pytest.raises(ValueError, match="centroids and d"):
        codec_from_arrays(device="cpu")
    with pytest.raises(ValueError, match="d ≤ S·ds"):
        codec_from_arrays(centroids=np.zeros((4, 8, 2), np.float32), d=9, device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        codec_from_arrays(scale=np.ones(3, np.float32), offset=np.zeros(4, np.float32),
                          device="cpu")


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


def _codec_of(ji):
    c = ji.codec
    if hasattr(c, "centroids"):
        return codec_from_arrays(centroids=np.asarray(c.centroids), d=c.d, device="cpu")
    return codec_from_arrays(scale=np.asarray(c.scale), offset=np.asarray(c.offset),
                             device="cpu")


_PAIRS = {}


def _pair(n, backend, options, force):
    """(JAX facade, port facade on the CPU) over the same data, A, codec
    and codes; cached per case."""
    key = (n, backend, tuple(sorted(options.items())), force)
    if key not in _PAIRS:
        data = make_clustered(n, D, seed=n)
        ji = jax_build_index(data, JaxConfig(backend=backend,
                                             options={**options, "force": force}))
        cls = FlatPQBackend if backend == "flat-pq" else FlatBackend
        ti = cls.from_arrays(data, np.asarray(ji.impl.family.a),
                             np.asarray(ji.impl.projected),
                             IndexConfig(backend=backend, options=options),
                             device="cpu", codec=_codec_of(ji), codes=np.asarray(ji.codes))
        _PAIRS[key] = (ji, ti, data)
    return _PAIRS[key]


def _same(rj, rt, *, selected=True, rtol=1e-6):
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.distances, rj.distances, rtol=rtol)
    sj, st = rj.stats.as_dict(), rt.stats.as_dict()
    if not selected:
        del sj["candidates_selected"], st["candidates_selected"]
    assert st == sj
    assert rt.indices.dtype == np.int32 and rt.distances.dtype == np.float32


CASES = [
    ("flat-pq", {}),
    ("flat", {"quant": "sq8"}),
    ("flat-pq", {"store_raw": False}),
    ("flat", {"quant": "sq8", "store_raw": False}),
]


@pytest.mark.parametrize("backend,options", CASES)
@pytest.mark.parametrize("n", [2048, 9000])  # both sides of the fused policy
def test_quant_search_matches_jax_ref(n, backend, options):
    ji, ti, data = _pair(n, backend, options, "ref")
    for B, k in ((1, 1), (7, 10)):
        q = _queries(data, B, seed=n + B + k)
        _same(ji.search(q, k), ti.search(q, k), selected=n < 8192)


@pytest.mark.parametrize("backend,options", CASES)
def test_quant_search_matches_jax_interpret(backend, options):
    """The JAX side runs the Pallas kernels themselves, the ADC kernel
    included (interpret mode), on the fused path."""
    ji, ti, data = _pair(1024, backend, {**options, "fused": True}, "interpret")
    q = _queries(data, 5, seed=31)
    rtol = 1e-4 if options.get("store_raw", True) else 1e-6
    _same(ji.search(q, 10), ti.search(q, 10), rtol=rtol)
    np.testing.assert_array_equal(ti.last_select_counts, ji.last_select_counts)


@pytest.mark.parametrize("fused,rerank", [(True, 64), (True, 300), (False, 300)])
def test_quant_rerank_budgets_match_jax(fused, rerank):
    """R ≤ 128 cuts by sort, R > 128 by radius select on the fused path."""
    ji, ti, data = _pair(3000, "flat-pq", {"fused": fused, "rerank": rerank}, "ref")
    q = _queries(data, 6, seed=32)
    _same(ji.search(q, 10), ti.search(q, 10), selected=not fused)


def test_quant_padding_and_non_finite_rows():
    ji, ti, data = _pair(2048, "flat-pq", {}, "ref")
    q = _queries(data, 4, seed=33)
    q[2, 5] = np.nan
    rj, rt = ji.search(q, 10), ti.search(q, 10)
    _same(rj, rt)  # n < 8192: the unfused path
    assert (rt.indices[2] == -1).all() and rt.stats.queries_rejected == 1
    small = make_clustered(40, 8, n_clusters=3, seed=34)
    jj = jax_build_index(small, JaxConfig(backend="flat-pq", options={"force": "ref"}))
    tt = FlatPQBackend.from_arrays(small, np.asarray(jj.impl.family.a),
                                   np.asarray(jj.impl.projected),
                                   IndexConfig(backend="flat-pq"), device="cpu",
                                   codec=_codec_of(jj), codes=np.asarray(jj.codes))
    qs = _queries(small, 2, seed=35)
    rj, rt = jj.search(qs, 64), tt.search(qs, 64)
    _same(rj, rt)
    assert (rt.indices[:, 40:] == -1).all()


@pytest.mark.parametrize("backend,options", CASES)
@pytest.mark.parametrize("n", [2048, 9000])
def test_quant_cp_search_matches_jax(n, backend, options):
    ji, ti, _ = _pair(n, backend, options, "ref")
    rj, rt = ji.cp_search(10), ti.cp_search(10)
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    np.testing.assert_allclose(rt.distances, rj.distances, **RTOL)
    assert rt.stats.as_dict() == rj.stats.as_dict()


def test_quant_cp_rerank_below_128_runs_the_join_path():
    ji, ti, _ = _pair(2048, "flat-pq", {"cp_rerank": 40}, "ref")
    before = dict(counts.ROUTES)
    rj, rt = ji.cp_search(10), ti.cp_search(10)
    assert counts.ROUTES == before  # R = 40: the plain join, no k > 128 route
    np.testing.assert_array_equal(rt.pairs, rj.pairs)
    assert rt.stats.as_dict() == rj.stats.as_dict()


def test_quant_ann_query_checks_budgets(dataset):
    index = build_index(dataset[:300], IndexConfig(backend="flat-pq"), device="cpu")
    q = torch.from_numpy(_queries(dataset, 2, seed=36))
    with pytest.raises(ValueError, match="k <= R <= T"):
        quant_ann_query(index.impl, index.codec, index.codes, q, k=10, T=50, R=60)


def test_flat_pq_registered_and_trains_pq_by_default(dataset):
    assert "flat-pq" in available_backends("quant")
    assert backend_capabilities("flat-pq") == frozenset({"ann", "quant", "cp"})
    assert backend_capabilities("flat") == frozenset({"ann", "cp"})
    index = build_index(dataset, IndexConfig(backend="flat-pq",
                                             options={"pq": {"m_codebooks": 8}}),
                        device="cpu")
    assert index.codec.n_slots == 8 and index.codes.dtype == torch.uint8
    q = _queries(dataset, 7, seed=37)
    res = index.search(q, 10)
    exact = np.argsort(((q[:, None, :] - dataset[None]) ** 2).sum(-1), axis=1)[:, :10]
    recall = np.mean([len(set(res.indices[i]) & set(exact[i])) / 10 for i in range(7)])
    assert recall > 0.8
    # B·T ADC distances on the codes, B·R exact ones on the float rows
    assert res.stats.point_distance_computations > res.stats.candidates_verified > 0


def test_store_raw_false_drops_the_float_rows(dataset):
    index = build_index(dataset, IndexConfig(backend="flat-pq",
                                             options={"store_raw": False}), device="cpu")
    assert index.impl.data.shape == (0, D) and index.data.shape == (0, D)
    res = index.search(_queries(dataset, 3, seed=38), 10)
    assert res.stats.candidates_verified == 0 and (res.indices >= 0).all()
