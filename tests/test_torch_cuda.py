"""The port's CUDA kernels held against their plain PyTorch versions, on
the card.

Every test here is marked ``cuda`` and skips visibly where
``torch.cuda.is_available()`` is false.  This file imports nothing of
JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: radius_select agrees exactly (same thresholds, integer
counts, copied values); verify's ids agree exactly and its d² to rtol
1e-5 (both sum the difference form, in another order); pairwise to
rtol 1e-5 and an atol of 1e-4 (the norm trick's cancellation at |q|²
+ |x|² of a few hundred, with the cross term summed in another order
than cuBLAS's).  adc_dist agrees exactly (both add the same table
entries in slot order).  pair_join's pairs and counters agree exactly
and its d² to rtol 1e-4 and an atol of 1e-6 · 2·max|x|² (the norm
trick's rounding is a few float32 ulps of |xi|² + |xj|², and the cross
terms are summed in another order than cuBLAS's).  topk_smallest
agrees exactly, values and indices (pure selection: the values are
copies).  project_dist agrees to |Δ| ≤ 1e-5·(|qp|² + |x·A|²) + 1e-6
(the projection is summed in another order than cuBLAS's).  The
streaming index's answers agree in ids; their d² to rtol 1e-5 and an
atol of 1e-6·(max|q|² + max|x|²), since the delta scan answers the
norm trick's d², as the reference's delta does.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import counts, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    """The card, or a visible skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _tie_cluster(device):
    d = torch.full((1, 600), 5.0, device=device)
    d[0, 597:] = 0.5  # the true top-T lives at the highest indices
    return d


def _verify_inputs(B, n, d, Tc, pad, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:Tc] for _ in range(B)]).astype(np.int32)
    if pad:
        cand[:, Tc - pad:] = -1
    return tuple(torch.from_numpy(a).to(device) for a in (data, q, cand))


@pytest.mark.parametrize("B,N,d", [(1, 100, 15), (5, 300, 64), (64, 4099, 15),
                                   (9, 1000, 256),
                                   # both sides of the narrow / wide switch
                                   (9, 1000, 32), (9, 1000, 33),
                                   # fewer points than a thread's 4; a stream segment
                                   (5, 1, 15), (5, 3, 15), (64, 36_799, 15),
                                   # queries past one staged chunk, narrow and wide
                                   (130, 3000, 15), (130, 3001, 256),
                                   # the delta scan after the stream's round 24
                                   (64, 16_374, 256)])
def test_pairwise_matches_plain(cuda, B, N, d):
    g = torch.Generator(device=cuda).manual_seed(B + N + d)
    q = torch.randn((B, d), generator=g, device=cuda)
    x = torch.randn((N, d), generator=g, device=cuda)
    before = counts.LAUNCHES["pairwise_sq_dist"]
    got = ops.pairwise_sq_dist(q, x)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["pairwise_sq_dist"] == before + 1
    torch.testing.assert_close(got, ops.pairwise_sq_dist(q, x, force="plain"),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [15, 33])
def test_pairwise_misaligned_x_matches_plain(cuda, d):
    """x one row in: its start is 4-byte aligned only (60 or 132 bytes
    past an aligned one)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((7, d), generator=g, device=cuda)
    x = torch.randn((1000, d), generator=g, device=cuda)[1:]
    assert x.data_ptr() % 16 != 0
    torch.testing.assert_close(ops.pairwise_sq_dist(q, x),
                               ops.pairwise_sq_dist(q, x, force="plain"), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,N,d", [(1, 7, 15), (4, 33, 16), (16, 406, 256)])
def test_pairwise_rows_matches_plain(cuda, B, N, d):
    g = torch.Generator(device=cuda).manual_seed(B + N + d)
    q = torch.randn((B, d), generator=g, device=cuda)
    x = torch.randn((B, N, d), generator=g, device=cuda)
    before = counts.LAUNCHES["pairwise_sq_dist_rows"]
    got = ops.pairwise_sq_dist(q, x)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["pairwise_sq_dist_rows"] == before + 1
    torch.testing.assert_close(got, ops.pairwise_sq_dist(q, x, force="plain"),
                               rtol=1e-5, atol=1e-5)


def _select_rows(kind, B, N, T, seed_scale, device):
    """(d, tau0) for radius_select: squared normals from a torch seed, or
    an edge row made with numpy."""
    if kind == "squared":
        g = torch.Generator(device=device).manual_seed(N + T)
        d = torch.randn((B, N), generator=g, device=device) ** 2
        return d, d.mean(1) * max(T / N, 1e-3) * seed_scale
    rng = np.random.default_rng(N + T)
    d = (rng.normal(size=(B, N)) ** 2).astype(np.float32)
    tau0 = d.mean(1) * T / N * seed_scale
    if kind == "collapsed":  # lo == hi: all zeros; an undershoot with τ0·r[15] >= dmax
        d[0] = 0.0
        d[1] = np.inf
        d[1, :50] = rng.uniform(1.0, 2.0, 50)
        tau0[:] = 1.0
    elif kind == "near_flt_max":  # lo + hi overflows: tree mids of +inf, values
        d = rng.uniform(1e38, 3.4e38, size=(B, N)).astype(np.float32)  # above hi,
        d[:, :100] = rng.uniform(0.0, 1e37, size=(B, 100))  # fewer real than T
        d[4, 100:600] = rng.uniform(1e38, 1.69e38, 500)
        d[4, 600:900] = np.float32(1.703e38)
        d[4, 900:] = rng.uniform(1.75e38, 3.4e38, N - 900)
        d[5, 100:] = np.inf
        d[5, :100] = rng.uniform(2e38, 3.4e38, 100)
        tau0 = np.array([2.9e38, 2.2e38, 1.5e38, 4e37, 1.703e38, 1e36], np.float32)
    elif kind == "inf_nan":  # padding and NaN are never counted
        d[rng.random(d.shape) < 0.1] = np.inf
        d[rng.random(d.shape) < 0.1] = np.nan
        d[-1, : N - 100] = np.inf  # fewer real entries than T
    elif kind == "small_integers":  # ties on the tree's mids
        d = rng.integers(0, 8, size=(B, N)).astype(np.float32)
        tau0 = d.mean(1) * T / N
    return torch.from_numpy(d).to(device), torch.from_numpy(tau0.astype(np.float32)).to(device)


@pytest.mark.parametrize("B,N,T,T_pad,seed_scale,kind", [
    (1, 100, 7, 71, 1.0, "squared"), (7, 700, 120, 184, 1.0, "squared"),
    (3, 20000, 2000, 2300, 1.0, "squared"), (2, 5000, 30, 94, 1e-9, "squared"),
    (2, 5000, 30, 94, 1e9, "squared"), (64, 9000, 900, 1156, 1.0, "squared"),
    (2, 600, 100, 200, 1.0, "collapsed"), (6, 2000, 800, 1990, 1.0, "near_flt_max"),
    (3, 2 * 4096 + 77, 150, 300, 1.0, "inf_nan"), (3, 3000, 300, 3000, 1.0, "small_integers"),
    (2, 1, 1, 1, 1.0, "squared"), (3, 1000, 1, 65, 1.0, "squared"),
    (2, 500, 500, 500, 1.0, "squared"),
])
def test_radius_select_matches_plain(cuda, B, N, T, T_pad, seed_scale, kind):
    from repro_torch.kernels.select import radius_select

    d, tau0 = _select_rows(kind, B, N, T, seed_scale, cuda)
    got = radius_select(d, tau0, T, T_pad=T_pad)
    want = ref.radius_select_kernel(d, tau0, T, T_pad=T_pad)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_radius_select_launches_four_kernels(cuda):
    """One call: the ladder, two histogram passes and the compaction.  The
    first launches of a trace can go unrecorded, so the trace holds two
    calls 20 ms apart and the kernels after the pause are counted."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.select import radius_select

    d, tau0 = _select_rows("squared", 4, 20000, 500, 1.0, cuda)
    radius_select(d, tau0, 500, T_pad=700)  # the build, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        radius_select(d, tau0, 500, T_pad=700)
        torch.cuda.synchronize()
        time.sleep(0.02)
        radius_select(d, tau0, 500, T_pad=700)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.cpu_time_total == 0 and (e.self_device_time_total or 0) > 0),
                     key=lambda e: e.time_range.start)
    gaps = [i for i in range(1, len(kernels))
            if kernels[i].time_range.start - kernels[i - 1].time_range.end > 10_000]
    second = kernels[gaps[-1]:] if gaps else kernels
    names = [e.name for e in second]
    launched = {name: sum(name in n for n in names)
                for name in ("select_ladder_kernel", "select_pass_kernel",
                             "select_compact_kernel")}
    assert launched == {"select_ladder_kernel": 1, "select_pass_kernel": 2,
                        "select_compact_kernel": 1}


def test_radius_select_overflow_matches_plain(cuda):
    from repro_torch.kernels.select import radius_select

    d = _tie_cluster(cuda)
    tau0 = torch.full((1,), 1.0, device=cuda)
    got = radius_select(d, tau0, 10, T_pad=100)
    want = ref.radius_select_kernel(d, tau0, 10, T_pad=100)
    assert int(got[2][0]) == 600
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    vals, idx = ops.radius_select(d, 10, T_pad=100)  # rerouted to the sort
    assert set(idx[0, :3].tolist()) == {597, 598, 599}


@pytest.mark.parametrize("B,n,d,Tc,k,pad", [
    (1, 50, 8, 10, 1, 0), (7, 129, 33, 64, 10, 20), (2, 40, 12, 6, 10, 2),
    (1, 20000, 256, 9000, 10, 0), (16, 5000, 64, 4000, 128, 100),
])
def test_verify_matches_plain(cuda, B, n, d, Tc, k, pad):
    data, q, cand = _verify_inputs(B, n, d, Tc, pad, seed=n, device=cuda)
    gv, gi = ops.verify_topk(data, q, cand, k)
    wv, wi = ops.verify_topk(data, q, cand, k, force="plain")
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)


def test_verify_exact_ties_go_to_earliest_position(cuda):
    data, q, cand = _verify_inputs(2, 40, 16, 12, 0, seed=21, device=cuda)
    data[9], data[8] = data[3], data[4]
    q[:] = data[3] + 0.01
    cand[0] = torch.tensor([9, 1, 3, 2, 8, 4, 5, 6, 7, 0, 11, 12], device=cuda)
    cand[1] = torch.tensor([3, 4, 9, 8, 1, 2, 5, 6, 7, 0, 11, 12], device=cuda)
    gv, gi = ops.verify_topk(data, q, cand, 10)
    wv, wi = ops.verify_topk(data, q, cand, 10, force="plain")
    assert torch.equal(gi, wi)
    assert int(gi[0, 0]) == 9 and int(gi[1, 0]) == 3


def _verify_card_case(name, device):
    """(data, q, cand, k) on the card: the batch sizes of the main path
    and a batch past one group of queries, row widths the distance pass
    takes in registers (15, 100: not a multiple of 32, 256), past them
    (600), and the counting sort's edges."""
    rng = np.random.default_rng(len(name) * 31)
    B, n, d, Tc, k = {"B1": (1, 20000, 256, 9000, 10), "B16": (16, 20000, 256, 9000, 10),
                      "B64": (64, 20000, 256, 9000, 10), "B130": (130, 20000, 256, 3000, 10),
                      "d15": (16, 5000, 15, 2000, 10), "d100": (16, 5000, 100, 2000, 10),
                      "d600": (8, 3000, 600, 1000, 10)}.get(name, (12, 3000, 64, 400, 10))
    data = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:Tc] for _ in range(B)]).astype(np.int32)
    if name == "hot_row":  # one row named by every query
        cand[cand == 77] = 78
        cand[:, 5] = 77
    elif name == "duplicates":  # a row twice in one query's list: both answer
        q[0] = data[5] + 0.01
        cand[0][cand[0] == 5] = 6
        cand[0, [3, 300]] = 5
    elif name == "all_padding":
        cand[2] = -1
        cand[4, 1:] = -1
    elif name == "tc_below_k":
        cand, k = cand[:, :6], 10
        cand[1, 4:] = -1
    elif name == "k_1":
        k = 1
    elif name == "k_128":
        k = 128
    elif name == "exact_ties":  # equal rows: the earlier position answers first
        data[9], data[8] = data[3], data[4]
        q[:] = data[3] + 0.01
        cand[np.isin(cand, [3, 4, 8, 9])] = 10
        cand[:, :4] = [9, 3, 8, 4]
    elif name == "nan_row":  # NaN d² sorts after +inf and keeps its id
        data[17, 2] = np.nan
        cand[cand == 17] = 18
        cand[:, 0] = 17
        cand[1, 5:] = -1
        k = 128
    return tuple(torch.from_numpy(a).to(device) for a in (data, q, cand)) + (k,)


VERIFY_CARD_CASES = ["B1", "B16", "B64", "B130", "d15", "d100", "d600", "hot_row",
                     "duplicates", "all_padding", "tc_below_k", "k_1", "k_128", "exact_ties",
                     "nan_row"]


@pytest.mark.parametrize("name", VERIFY_CARD_CASES)
def test_verify_schedule_cases_match_plain(cuda, name):
    """ids identical to the plain version's, d² to rtol 1e-5 (NaN where it
    has NaN); one launch count for verify and none for topk, whose kernel
    verify runs from C; each distinct row read once a group of queries."""
    from repro_torch.kernels import verify as kver

    data, q, cand, k = _verify_card_case(name, cuda)
    before = dict(counts.LAUNCHES)
    gv, gi, rows_read = kver.verify_topk(data, q, cand, k, rows_read=True)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["verify_topk"] == before["verify_topk"] + 1
    assert counts.LAUNCHES["topk_smallest"] == before["topk_smallest"]
    wv, wi = ref.verify_topk(data, q, cand, k)
    assert torch.equal(gi, wi)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5, equal_nan=True)
    G = kver.group_size(q.shape[0], data.shape[1])
    assert int(rows_read) == sum(int(torch.unique(c[c >= 0]).numel()) for c in cand.split(G))
    if name == "B130":
        assert G < 130  # the case crosses query groups
    if name == "duplicates":
        assert gi[0, :2].tolist() == [5, 5]
    if name == "exact_ties":
        assert gi[:, :2].tolist() == [[9, 3]] * cand.shape[0]


def test_verify_launches_its_schedule(cuda):
    """One group: the count, three scan kernels, the scatter, the distance
    pass and the topk kernel's two launches (one memset before)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.verify import verify_topk

    data, q, cand, k = _verify_card_case("B64", cuda)
    verify_topk(data, q, cand, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        verify_topk(data, q, cand, k)
        torch.cuda.synchronize()
        time.sleep(0.02)
        verify_topk(data, q, cand, k)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.cpu_time_total == 0 and (e.self_device_time_total or 0) > 0),
                     key=lambda e: e.time_range.start)
    gaps = [i for i in range(1, len(kernels))
            if kernels[i].time_range.start - kernels[i - 1].time_range.end > 10_000]
    names = [e.name for e in (kernels[gaps[-1]:] if gaps else kernels)]
    launched = {name: sum(name in n for n in names)
                for name in ("verify_entries_kernel", "verify_tile_", "verify_dist_kernel",
                             "topk_kernel")}
    assert launched == {"verify_entries_kernel": 2, "verify_tile_": 3,
                        "verify_dist_kernel": 1, "topk_kernel": 2}
    assert not any("select_" in n for n in names)


@pytest.mark.parametrize("n", [2048, 9000])
def test_flat_facade_matches_plain(cuda, n):
    """The whole flat path on the card: kernels against plain versions."""
    from repro_torch.index import IndexConfig, build_index

    rng = np.random.default_rng(n)
    data = (rng.normal(size=(20, 64)) * 4)[rng.integers(0, 20, n)]
    data = (data + rng.normal(size=(n, 64)) * 0.5).astype(np.float32)
    q = (data[rng.integers(0, n, 7)] + 0.1 * rng.normal(size=(7, 64))).astype(np.float32)
    kern = build_index(data, IndexConfig(backend="flat"), device=cuda)
    plain = build_index(data, IndexConfig(backend="flat", options={"use_kernels": False}),
                        device=cuda)
    counts.reset()
    rk = kern.search(q, 10)
    used = counts.snapshot()["launches"]
    rp = plain.search(q, 10)
    np.testing.assert_array_equal(rk.indices, rp.indices)
    np.testing.assert_allclose(rk.distances, rp.distances, rtol=1e-6)
    assert rk.stats.candidates_verified == rp.stats.candidates_verified
    if n >= 8192:
        assert used["radius_select"] == 1 and used["verify_topk"] == 1
    else:
        assert used["pairwise_sq_dist_rows"] == 1
    assert used["pairwise_sq_dist"] == 1


@pytest.mark.parametrize("B,N,S,V,per_query", [
    (1, 100, 16, 256, False), (5, 3001, 16, 256, False), (64, 4099, 16, 256, True),
    (3, 500, 7, 100, True), (2, 300, 96, 256, False), (4, 2048, 32, 256, True),
])
def test_adc_matches_plain(cuda, B, N, S, V, per_query):
    rng = np.random.default_rng(B + N + S)
    shape = (B, N, S) if per_query else (N, S)
    codes = torch.from_numpy(rng.integers(0, V, shape).astype(np.uint8)).to(cuda)
    lut = torch.from_numpy(rng.random((B, S, V)).astype(np.float32)).to(cuda)
    before = counts.LAUNCHES["adc_dist"]
    got = ops.adc_dist(codes, lut)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["adc_dist"] == before + 1
    assert torch.equal(got, ops.adc_dist(codes, lut, force="plain"))


def test_adc_unaligned_codes(cuda):
    """A view that starts one byte in takes the kernel's byte loads."""
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, 700 * 16 + 1).astype(np.uint8)).to(cuda)
    codes = raw[1:].view(700, 16)
    lut = torch.from_numpy(rng.random((3, 16, 256)).astype(np.float32)).to(cuda)
    from repro_torch.kernels.adc import adc_dist

    assert torch.equal(adc_dist(codes, lut), ref.adc_dist(codes, lut))


def _sorted_rows(x, seed):
    rng = np.random.default_rng(seed)
    key = x @ rng.normal(size=(x.shape[1],)).astype(np.float32)
    order = np.argsort(key, kind="stable")
    return x[order], key[order].astype(np.float32)


def _pair_join_case(name):
    rng = np.random.default_rng(len(name))
    if name == "two_clusters":  # 40 apart on one axis: |x|² stays small, so the
        # norm trick's rounding stays far below the gaps between pair distances
        x = np.concatenate([rng.normal(size=(256, 8)), rng.normal(size=(256, 8))])
        x[256:, 0] += 40.0
        x = x.astype(np.float32)
        order = np.argsort(x[:, 0], kind="stable")
        return x[order], x[order, 0].copy(), 10, 16.0
    n, d, k, t2 = {"single_tile": (64, 8, 5, np.inf), "partial_tile": (100, 12, 1, 9.0),
                   "live_pruning": (300, 16, 10, 16.0), "ragged": (513, 24, 16, 16.0),
                   "fewer_pairs_than_k": (4, 6, 10, np.inf), "k_128": (1000, 32, 128, 16.0),
                   "many_bands": (6000, 48, 10, 16.0), "gamma_0": (700, 16, 10, 0.0),
                   "several_groups": (20000, 64, 10, 16.0),  # bands in several groups
                   "d_not_multiple_of_4": (3000, 33, 10, 16.0)}[name]  # 4-byte copies
    x = rng.normal(size=(n, d)).astype(np.float32)
    return (*_sorted_rows(x, n), k, t2)


@pytest.mark.parametrize("name", ["single_tile", "partial_tile", "live_pruning", "ragged",
                                  "two_clusters", "fewer_pairs_than_k", "k_128",
                                  "many_bands", "gamma_0", "several_groups",
                                  "d_not_multiple_of_4"])
def test_pair_join_matches_plain(cuda, name):
    xs, ks, k, t2 = _pair_join_case(name)
    x, key = torch.from_numpy(xs).to(cuda), torch.from_numpy(ks).to(cuda)
    before = counts.LAUNCHES["pair_join"]
    gv, gi, gj, gs = ops.pair_join(x, key, k, thresh2=t2)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["pair_join"] == before + 1
    wv, wi, wj, ws = ops.pair_join(x, key, k, thresh2=t2, force="plain")
    assert torch.equal(gi, wi) and torch.equal(gj, wj)
    assert gs.tolist() == ws.tolist()
    atol = 1e-6 * 2 * float((x * x).sum(1).max())
    torch.testing.assert_close(gv, wv, rtol=1e-4, atol=atol)
    if name == "two_clusters":
        assert gs[1] > 0  # cross-cluster tiles pruned


@pytest.mark.parametrize("name", ["many_bands", "d_not_multiple_of_4"])
def test_pair_join_reads_nothing_back_and_repeats_bit_for_bit(cuda, name):
    """No host sync a call, and a repeat call bit for bit: the kernel's
    atomics decide which block computes a tile and where a key waits for
    its sort, never the answer."""
    xs, ks, k, t2 = _pair_join_case(name)
    x, key = torch.from_numpy(xs).to(cuda), torch.from_numpy(ks).to(cuda)
    ops.pair_join(x, key, k, thresh2=t2)  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = ops.pair_join(x, key, k, thresh2=t2)
        again = ops.pair_join(x, key, k, thresh2=t2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float32 else a,
                           b.view(torch.uint8) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("backend,options", [
    ("flat", {}), ("flat-pq", {}), ("flat", {"quant": "sq8"}),
    ("flat-pq", {"store_raw": False}),
])
def test_cp_and_quant_facades_match_plain(cuda, backend, options):
    """cp_search, and search on the quantized backends, on the card:
    kernels against plain versions on one index."""
    from repro_torch.core.cp_fused import cp_fused_search
    from repro_torch.index import IndexConfig, build_index

    rng = np.random.default_rng(17)
    data = (rng.normal(size=(20, 64)) * 4)[rng.integers(0, 20, 9000)]
    data = (data + rng.normal(size=(9000, 64)) * 0.5).astype(np.float32)
    q = (data[rng.integers(0, 9000, 7)] + 0.1 * rng.normal(size=(7, 64))).astype(np.float32)
    kern = build_index(data, IndexConfig(backend=backend, options=options), device=cuda)
    plain = build_index(data, IndexConfig(backend=backend,
                                          options={**options, "use_kernels": False}), device=cuda)
    counts.reset()
    ck = kern.cp_search(10)
    used = counts.snapshot()
    cp_plain = plain.cp_search(10)
    np.testing.assert_array_equal(ck.pairs, cp_plain.pairs)
    np.testing.assert_allclose(ck.distances, cp_plain.distances, rtol=1e-6)
    assert ck.stats == cp_plain.stats
    if kern.codec is None:
        assert used["launches"]["pair_join"] == 1
        full = cp_fused_search(kern.impl.data, 10, gamma=1e6, key=kern.impl.projected[:, 0])
        assert set(map(tuple, ck.pairs.tolist())) == set(map(tuple, full.pairs.tolist()))
        return
    assert used["routes"]["pair_join.k_over_128"] == 1  # R = 1024 > 128
    counts.reset()
    rk = kern.search(q, 10)
    used = counts.snapshot()["launches"]
    rp = plain.search(q, 10)
    np.testing.assert_array_equal(rk.indices, rp.indices)
    np.testing.assert_allclose(rk.distances, rp.distances, rtol=1e-6)
    assert rk.stats == rp.stats
    assert used["radius_select"] >= 1 and used["pairwise_sq_dist"] == 1
    if backend == "flat-pq":
        assert used["adc_dist"] == 1


def test_wrappers_reject_cpu_tensors(cuda):
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dist

    with pytest.raises(ValueError, match="CUDA tensor"):
        pairwise_sq_dist(torch.zeros(2, 3), torch.zeros(4, 3))
    assert pairwise_sq_dist(torch.zeros(2, 3, device=cuda),
                            torch.zeros(4, 3, device=cuda)).shape == (2, 4)


def _topk_input(name, device):
    g = torch.Generator(device=device).manual_seed(len(name))
    B, N, k = {"delta_scan": (64, 32768, 10), "merge": (64, 47, 10), "k_1": (3, 5000, 1),
               "k_128": (5, 9000, 128), "short_row": (4, 700, 10),
               "ragged": (2, 2049 * 3 + 5, 33), "all_equal": (3, 4100, 16),
               "few_finite": (3, 3000, 8), "nan_and_zeros": (2, 2500, 20),
               "k_equals_N": (2, 40, 40), "verify_shape": (64, 96704, 10),
               "ascending": (4, 50000, 10), "descending": (4, 50000, 10),
               "over_one_split": (3, 8192 + 3, 128), "signed_zeros": (2, 20000, 32),
               "nan_inf": (3, 20000, 12)}[name]
    d = torch.rand((B, N), generator=g, device=device)
    if name == "ascending":
        d = torch.sort(d, 1).values
    elif name == "descending":  # every key passes the threshold: sorts every chunk
        d = torch.sort(d, 1, descending=True).values
    elif name == "signed_zeros":
        d[0, ::7] = 0.0
        d[0, 3::11] = -0.0
        d[1, 5::13] = -0.0
    elif name == "nan_inf":
        d[0, ::3] = float("nan")
        d[1, :19990] = float("nan")
        d[1, 19995:] = float("inf")
        d[2, ::2] = float("inf")
    if name == "all_equal":
        d = torch.full((B, N), 7.0, device=device)
    elif name == "few_finite":
        d[0] = float("inf")
        d[0, [5, 2999]] = torch.tensor([2.0, 1.0], device=device)
    elif name == "nan_and_zeros":
        d[0, ::7] = 0.0
        d[0, 3::11] = -0.0
        d[1, ::5] = float("nan")
        d[1, :40] = float("inf")
    return d, k


@pytest.mark.parametrize("name", ["delta_scan", "merge", "k_1", "k_128", "short_row",
                                  "ragged", "all_equal", "few_finite", "nan_and_zeros",
                                  "k_equals_N", "verify_shape", "ascending", "descending",
                                  "over_one_split", "signed_zeros", "nan_inf"])
def test_topk_matches_plain(cuda, name):
    d, k = _topk_input(name, cuda)
    before = counts.LAUNCHES["topk_smallest"]
    gv, gi = ops.topk_smallest(d, k)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["topk_smallest"] == before + 1
    wv, wi = ops.topk_smallest(d, k, force="plain")
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))  # bit for bit


def test_topk_k_over_128_takes_radius_select(cuda):
    d = torch.rand((4, 20000), device=cuda)
    before = dict(counts.snapshot()["launches"]), dict(counts.ROUTES)
    gv, gi = ops.topk_smallest(d, 300)
    assert counts.ROUTES["topk_smallest.k_over_128"] == before[1]["topk_smallest.k_over_128"] + 1
    assert counts.LAUNCHES["radius_select"] == before[0]["radius_select"] + 1
    assert counts.LAUNCHES["topk_smallest"] == before[0]["topk_smallest"]
    wv, wi = ops.topk_smallest(d, 300, force="plain")
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("B,N,d,m", [(64, 100_003, 256, 15), (1, 4099, 4096, 15),
                                     (7, 777, 33, 16), (70, 5000, 96, 20), (3, 100, 8, 1),
                                     # N % 4 != 0, a wide d, m = 32
                                     (5, 1001, 64, 15), (5, 3000, 600, 15),
                                     (9, 2000, 256, 32)])
def test_project_dist_matches_plain(cuda, B, N, d, m):
    g = torch.Generator(device=cuda).manual_seed(B + N + d + m)
    x = torch.randn((N, d), generator=g, device=cuda)
    a = torch.randn((d, m), generator=g, device=cuda)
    qp = torch.randn((B, d), generator=g, device=cuda) @ a
    before = counts.LAUNCHES["project_dist"]
    got = ops.project_dist(x, a, qp)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["project_dist"] == before + 1
    want = ops.project_dist(x, a, qp, force="plain")
    tol = 1e-5 * ((qp * qp).sum(1)[:, None] + ((x @ a) ** 2).sum(1)[None]) + 1e-6
    assert bool(((got - want).abs() <= tol).all())


def test_project_dist_misaligned_x_matches_plain(cuda):
    """x one float past an aligned start: the 4-byte copies."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((999 * 256 + 1,), generator=g, device=cuda)[1:].view(999, 256)
    a = torch.randn((256, 15), generator=g, device=cuda)
    qp = torch.randn((5, 256), generator=g, device=cuda) @ a
    assert x.data_ptr() % 16 != 0
    got = ops.project_dist(x, a, qp)
    want = ops.project_dist(x, a, qp, force="plain")
    tol = 1e-5 * ((qp * qp).sum(1)[:, None] + ((x @ a) ** 2).sum(1)[None]) + 1e-6
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("kernel,d", [("pairwise_narrow_kernel", 15),
                                      ("pairwise_wide_kernel", 256),
                                      ("project_dist_kernel", 256)])
def test_distance_wrappers_launch_one_kernel(cuda, kernel, d):
    """Each call of pairwise_sq_dist (either schedule) or project_dist is
    one CUDA kernel, named for its schedule."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.pairwise_dist import pairwise_sq_dist
    from repro_torch.kernels.project_dist import project_dist

    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((20_000, d), generator=g, device=cuda)
    if kernel == "project_dist_kernel":
        a = torch.randn((d, 15), generator=g, device=cuda)
        qp = torch.randn((64, 15), generator=g, device=cuda)
        call = lambda: project_dist(x, a, qp)  # noqa: E731
    else:
        q = torch.randn((64, d), generator=g, device=cuda)
        call = lambda: pairwise_sq_dist(q, x)  # noqa: E731
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
        time.sleep(0.02)
        call()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.cpu_time_total == 0 and (e.self_device_time_total or 0) > 0),
                     key=lambda e: e.time_range.start)
    gaps = [i for i in range(1, len(kernels))
            if kernels[i].time_range.start - kernels[i - 1].time_range.end > 10_000]
    names = [e.name for e in (kernels[gaps[-1]:] if gaps else kernels)]
    assert len(names) == 1 and kernel in names[0], names


def test_flat_use_kernels_false_launches_nothing(cuda):
    from repro_torch.index import IndexConfig, build_index

    rng = np.random.default_rng(5)
    data = rng.normal(size=(9000, 32)).astype(np.float32)
    index = build_index(data, IndexConfig(backend="flat", options={"use_kernels": False}),
                        device=cuda)
    counts.reset()
    index.search(data[:5] + 0.01, 10)
    index.cp_search(5)
    assert not any(counts.LAUNCHES.values())


@pytest.mark.parametrize("segment_backend", ["flat", "flat-pq"])
def test_streaming_facade_matches_plain_twin(cuda, segment_backend):
    """The streaming index on the card against a use_kernels=False twin
    fed the same operations: ids, pairs and counters identical."""
    from repro_torch.index import IndexConfig, build_index

    rng = np.random.default_rng(23)
    centers = rng.normal(size=(20, 64)) * 4
    data = (centers[rng.integers(0, 20, 9000)] + rng.normal(size=(9000, 64)) * 0.5
            ).astype(np.float32)
    opts = {"segment_backend": segment_backend, "delta_threshold": 1024, "max_segments": 3}
    kern = build_index(data[:6000], IndexConfig(backend="streaming", options=opts),
                       device=cuda)
    plain = build_index(data[:6000], IndexConfig(
        backend="streaming", options={**opts, "use_kernels": False}), device=cuda)
    q = (data[rng.integers(0, 9000, 7)] + 0.1 * rng.normal(size=(7, 64))).astype(np.float32)
    counts.reset()
    for lo in range(6000, 9000, 700):
        for index in (kern, plain):
            index.insert(data[lo:lo + 700])
            index.delete(np.arange(lo - 600, lo - 590))
        rk, rp = kern.search(q, 10), plain.search(q, 10)
        np.testing.assert_array_equal(rk.indices, rp.indices)
        # the delta answers sqrt of its norm-trick d², as the reference's
        # does: a few float32 ulps of |q|² + |x|², as for the pairwise kernel
        atol = 1e-6 * float((q ** 2).sum(1).max() + (data ** 2).sum(1).max())
        np.testing.assert_allclose(rk.distances ** 2, rp.distances ** 2, rtol=1e-5,
                                   atol=atol)
    assert kern.n_flushes == plain.n_flushes >= 2 and kern.n_compactions >= 1
    assert kern.delta_size > 0 and counts.LAUNCHES["topk_smallest"] > 0
    ck, cp = kern.cp_search(10), plain.cp_search(10)
    np.testing.assert_array_equal(ck.pairs, cp.pairs)
    assert ck.stats == cp.stats


@pytest.mark.parametrize("op", ["pairwise_sq_dist", "verify_topk"])
def test_traced_kernel_span_covers_its_kernel(cuda, op):
    """With tracing on, a kernel span opens after its inputs and closes
    after its outputs are synchronized: its wall time covers the kernel's
    own time by CUDA events (the median of 5 untraced calls)."""
    from repro_torch.obs import trace

    rng = np.random.default_rng(23)
    if op == "pairwise_sq_dist":
        q = torch.from_numpy(rng.normal(size=(64, 15)).astype(np.float32)).to(cuda)
        x = torch.from_numpy(rng.normal(size=(400_000, 15)).astype(np.float32)).to(cuda)
        call = lambda: ops.pairwise_sq_dist(q, x)  # noqa: E731
    else:
        data, q, cand = _verify_inputs(64, 200_000, 256, 20_000, 0, 23, cuda)
        call = lambda: ops.verify_topk(data, q, cand, 10)  # noqa: E731
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with trace.trace() as tr:
        call()
    (span,) = tr.spans
    assert span.name == "kernel." + op and span.attrs["bytes"] > 0
    assert span.duration_s * 1e3 >= 0.9 * sorted(times)[2]
    if op == "verify_topk":  # refined from the rows its distance pass read
        assert 0 < span.attrs["rows_read"] <= 200_000


def test_scheduler_on_the_card_matches_the_plain_twin(cuda):
    """A small RequestScheduler over a flat datastore on the card (fused:
    n ≥ 8192) with the kernels, beside the same traffic through a
    ``use_kernels=False`` twin: the same statuses, ids, payloads and
    bucket shapes, distances to rtol 1e-6; the kernels launched only in
    the kernel twin, and a pass of cache hits launches nothing."""
    from repro_torch.index import IndexConfig
    from repro_torch.serve import RequestScheduler, ServeConfig
    from repro_torch.serve.serve_step import make_retrieval_step

    rng = np.random.default_rng(31)
    centers = rng.normal(size=(20, 48)) * 4
    keys = (centers[rng.integers(0, 20, 12_000)] + rng.normal(size=(12_000, 48)) * 0.5
            ).astype(np.float32)
    q = keys[rng.integers(0, 12_000, 40)] + 0.01
    ks = [int(k) for k in rng.choice([1, 3, 10, 16, 100], 40)]
    runs = []
    for options in ({}, {"use_kernels": False}):
        step, _ = make_retrieval_step(keys, np.arange(12_000) * 3, k=10, device=cuda,
                                      index_config=IndexConfig(backend="flat", options=options))
        sched = RequestScheduler(step, config=ServeConfig(b_max=16, k_max=128,
                                                          default_deadline_ms=1e6))
        counts.reset()
        tickets = [sched.submit(qi, k=k) for qi, k in zip(q, ks)]
        sched.drain()
        resps = [t.result() for t in tickets]
        launched = counts.snapshot()["launches"]
        counts.reset()
        hits = [sched.submit(qi, k=k).result() for qi, k in zip(q, ks)]
        assert all(h.cached for h in hits) and not any(counts.LAUNCHES.values())
        runs.append((resps, launched, sorted(b.shape for b in sched.snapshot().buckets)))
    (kern, used, shapes), (plain, unused, plain_shapes) = runs
    assert shapes == plain_shapes
    for a, b in zip(kern, plain):
        assert a.ok and b.ok
        np.testing.assert_array_equal(a.result.indices, b.result.indices)
        np.testing.assert_array_equal(a.payloads, b.payloads)
        np.testing.assert_allclose(a.result.distances, b.result.distances, rtol=1e-6)
    assert all(used[name] > 0 for name in ("pairwise_sq_dist", "radius_select", "verify_topk"))
    assert not any(unused.values())


def _sharded_data(n, d, seed):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(20, d)) * 4)[rng.integers(0, 20, n)]
    data = (data + rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    q = (data[rng.integers(0, n, 7)] + 0.1 * rng.normal(size=(7, d))).astype(np.float32)
    return data, q


def test_sharded_flat_matches_flat_on_the_card(cuda):
    """``sharded-flat`` over an emulated P = 4 mesh on the card answers
    ``flat``'s ids and distances bit for bit (the estimate is the flat
    index's pairwise kernel on each shard's rows, the answer floats the
    same arithmetic on the same rows), and its closest pairs are flat's;
    pairwise and verify launch once a shard, radius_select never."""
    from repro_torch.index import IndexConfig, build_index

    data, q = _sharded_data(9001, 48, 41)  # 9001 ∤ 4: the last shard pads
    flat = build_index(data, IndexConfig(backend="flat"), device=cuda)
    sh = build_index(data, IndexConfig(backend="sharded-flat", options={"shards": 4}),
                     device=cuda)
    rf = flat.search(q, 10)
    counts.reset()
    rs = sh.search(q, 10)
    used = counts.snapshot()["launches"]
    np.testing.assert_array_equal(rs.indices, rf.indices)
    np.testing.assert_array_equal(rs.distances, rf.distances)
    assert rs.stats.candidates_selected == rf.stats.candidates_selected
    assert (used["pairwise_sq_dist"], used["verify_topk"], used["radius_select"]) == (4, 4, 0)
    cf, cs = flat.cp_search(10), sh.cp_search(10)
    np.testing.assert_array_equal(cs.pairs, cf.pairs)
    np.testing.assert_array_equal(cs.distances, cf.distances)


def test_sharded_flat_nccl_group_of_one_matches_emulated(cuda, tmp_path):
    """A world-size-1 NCCL group answers what the emulated P = 1 mesh
    answers, bit for bit (ANN and CP)."""
    import torch.distributed as dist

    from repro_torch.index import IndexConfig, build_index
    from repro_torch.launch import make_data_mesh

    data, q = _sharded_data(3001, 32, 43)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh = make_data_mesh(device="cuda")
        assert not mesh.emulated and mesh.size == 1
        grp = build_index(data, IndexConfig(backend="sharded-flat", options={"mesh": mesh}),
                          device=cuda)
        rg, cg = grp.search(q, 10), grp.cp_search(5)
    finally:
        dist.destroy_process_group()
    emu = build_index(data, IndexConfig(backend="sharded-flat", options={"shards": 1}),
                      device=cuda)
    re_, ce = emu.search(q, 10), emu.cp_search(5)
    np.testing.assert_array_equal(rg.indices, re_.indices)
    np.testing.assert_array_equal(rg.distances, re_.distances)
    np.testing.assert_array_equal(cg.pairs, ce.pairs)
    np.testing.assert_array_equal(cg.distances, ce.distances)
