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


@pytest.mark.parametrize("d", [15, 64, 256])  # 256: the stream's delta scan
@pytest.mark.parametrize("N", [100, 300, 1001])
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
# radius_select: the CUDA kernel's pass schedule (csrc/select.cu)
# ---------------------------------------------------------------------------
#
# The CUDA kernel resolves the 14 bisection steps in two histogram passes
# of 7 levels.  It cannot run here, so this model repeats its schedule in
# PyTorch, step by step, and must agree with ref.radius_select_kernel
# exactly: the same survivors in the same slots and the same counts.

_LEVELS = 7  # bisection steps one pass resolves (select.cu's kLevels)
_BINS = 1 << _LEVELS


def _mid(lo, hi):
    return 0.5 * (lo + hi)  # float32 0-d tensors: __fmul_rn(0.5f, __fadd_rn(lo, hi))


def _ladder_bins(v, thr):
    """Each element's rung: the first l with v <= thr[l] by a 4-step
    binary search and one last compare; 16 where none holds."""
    rung = torch.zeros(v.shape, dtype=torch.int64)
    for step in (8, 4, 2, 1):
        rung = torch.where(v <= thr[rung + step - 1], rung, rung + step)
    return torch.where(v <= thr[rung], rung, thr.numel())


def _tree_mids(lo, hi):
    """The mids of the next 7 steps from (lo, hi), in heap order (1..127):
    node i's bracket is its parent's, cut at the parent's mid."""
    mids = torch.zeros(_BINS, dtype=torch.float32)
    for node in range(1, _BINS):
        depth = node.bit_length() - 1
        a, b = lo, hi
        for level in range(depth):
            m = _mid(a, b)
            if (node >> (depth - 1 - level)) & 1:
                a = m
            else:
                b = m
        mids[node] = _mid(a, b)
    return mids


def _pass_hist(v, real, lo, hi, mids):
    """One pass over some elements: [below, 128 leaves, above] counts.
    Elements <= lo lie below every mid; those > hi skip the tree; the
    rest descend it, going left where v <= the node's mid.  Where every
    mid is finite, the kernel guesses the leaf from v's place in (lo, hi]
    and keeps the guess where the in-order mids (the leaves' edges) hold v."""
    below = real & (v <= lo)
    above = real & ~below & (v > hi)
    x = v[real & ~below & ~above]
    node = torch.ones(x.shape, dtype=torch.int64)
    for _ in range(_LEVELS):
        node = 2 * node + (x > mids[node]).to(torch.int64)
    leaf = node - _BINS
    if bool(torch.isfinite(mids[1:]).all()):
        edges = torch.empty(_BINS + 1)
        edges[0], edges[_BINS] = lo, hi
        for n in range(1, _BINS):
            depth = n.bit_length() - 1
            edges[(2 * (n - (1 << depth)) + 1) << (_LEVELS - 1 - depth)] = mids[n]
        assert torch.equal(edges[1:_BINS], torch.sort(mids[1:]).values)  # in order
        scale = torch.tensor(float(_BINS), dtype=torch.float32) / (hi - lo)
        guess = torch.clamp(((x - lo) * scale).to(torch.int64), 0, _BINS - 1)
        hit = (x > edges[guess]) & (x <= edges[guess + 1])
        leaf = torch.where(hit, guess, leaf)
    leaves = torch.bincount(leaf, minlength=_BINS)
    return torch.cat([below.sum().reshape(1), leaves, above.sum().reshape(1)])


def _walk(cum, lo, hi, T):
    """7 bisection steps read off one pass's inclusive scan `cum`
    (130 counts): count(d <= a node's mid) is cum[its left subtree's
    last leaf + 1]; a node whose mid is +inf counts every real element.
    Returns the new bracket and the leaf reached."""
    node = 1
    for depth in range(_LEVELS):
        mid = _mid(lo, hi)
        first = (node - (1 << depth)) << (_LEVELS - depth)
        c = cum[_BINS + 1] if torch.isinf(mid) else cum[first + (1 << (_LEVELS - 1 - depth))]
        if c >= T:
            hi, node = mid, 2 * node
        else:
            lo, node = mid, 2 * node + 1
    return lo, hi, node - _BINS


def _ladder_bracket(v, real, tau0, T):
    """The bracket after the ladder pass, whose rung counts are the scan
    of a 16-bin histogram (select.cu's ladder_bracket)."""
    thr = tau0 * ref.select_rungs()
    lad = torch.cumsum(torch.bincount(_ladder_bins(v, thr)[real], minlength=17)[:16], 0)
    dmax = torch.clamp_min(torch.where(real, v, -float("inf")).max(), 0.0)
    first = int(torch.nonzero(lad >= T)[0]) if bool((lad >= T).any()) else -1
    hi = torch.minimum(thr[first] if first >= 0 else dmax, dmax)
    lo = thr[first - 1] if first > 0 else torch.tensor(0.0)
    if first < 0:
        lo = thr[15]
    return torch.minimum(lo, hi), hi


def _histogram_select(d, tau0, T, T_pad, tile=16384):
    """radius_select by select.cu's schedule: a 16-bin ladder pass, two
    7-level histogram passes (the second also keeps each tile's scan),
    and a compaction that places each tile's survivors after the counts
    of the tiles before it.  Returns ref's triple and, per row, the passes
    whose tree held a +inf mid while real elements lay above their hi."""
    d = d.to(torch.float32)
    B, N = d.shape
    tau0 = torch.clamp_min(tau0.to(torch.float32), 1e-30)
    vals = torch.full((B, T_pad), float("inf"))
    idx = torch.full((B, T_pad), -1, dtype=torch.int32)
    count = torch.zeros(B, dtype=torch.int32)
    hazard = []
    for b in range(B):
        v, real = d[b], d[b] < float("inf")
        lo, hi = _ladder_bracket(v, real, tau0[b], T)
        row_hazard = set()
        for p in range(2):
            mids = _tree_mids(lo, hi)
            if torch.isinf(mids[1:]).any() and (real & (v > hi)).any():
                row_hazard.add(p)
            cum = torch.cumsum(_pass_hist(v, real, lo, hi, mids), 0)
            if p == 1:  # each tile's scan, for the compaction
                tiles = [torch.cumsum(_pass_hist(v[s:s + tile], real[s:s + tile], lo, hi,
                                                 mids), 0) for s in range(0, N, tile)]
            lo, hi, leaf = _walk(cum, lo, hi, T)
        slot = _BINS + 1 if torch.isinf(hi) else leaf + 1
        # compaction: a tile's survivors start after the tiles before it
        pos = 0
        for t, s in enumerate(range(0, N, tile)):
            keep = torch.nonzero(real[s:s + tile] & (v[s:s + tile] <= hi))[:, 0]
            slots = pos + torch.arange(keep.numel())
            ok = slots < T_pad
            vals[b, slots[ok]] = v[s + keep[ok]]
            idx[b, slots[ok]] = (s + keep[ok]).to(torch.int32)
            pos += int(tiles[t][slot])
        count[b] = pos
        hazard.append(row_hazard)
    return (vals, idx, count), hazard


def _schedule_case(name):
    """(d, tau0, T, T_pad) for one case, made with numpy from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    sq = lambda B, N: (rng.normal(size=(B, N)) ** 2 * 3).astype(np.float32)
    seed = lambda d, T, s=1.0: (d.mean(1) * T / d.shape[1] * s).astype(np.float32)
    if name == "squared_normals":
        d = sq(3, 5000)
        return d, seed(d, 400), 400, 520
    if name == "rung_tie":  # 300 equal values on a rung edge, τ0·r[9]
        d, T = sq(2, 3000), 700
        tau0 = seed(d, T)
        d[:, 1000:1300] = (_t(tau0) * ref.select_rungs()[9]).numpy()[:, None]
        return d, tau0, T, 1000
    if name == "tree_tie":  # 300 equal values on the first pass's root mid
        d, T = sq(2, 3000), 700
        tau0 = seed(d, T)
        for _ in range(4):  # the cluster moves the bracket: iterate to a fixed point
            edge = np.array([float(_mid(*_ladder_bracket(_t(d[b]), _t(d[b] < np.inf),
                                                         _t(tau0)[b], T)))
                             for b in range(2)], np.float32)
            done = bool((d[:, 1000] == edge).all())
            d[:, 1000:1300] = edge[:, None]
        assert done
        return d, tau0, T, 1000
    if name == "collapsed":  # all zeros: lo == hi == 0; and an undershoot with
        d = np.zeros((2, 600), np.float32)  # τ0·r[15] >= dmax collapses too
        d[1] = np.inf
        d[1, :50] = rng.uniform(1.0, 2.0, 50)
        return d, np.array([1.0, 1.0], np.float32), 100, 200
    if name == "small_integers":
        d = rng.integers(0, 8, size=(3, 3000)).astype(np.float32)
        return d, seed(d, 300), 300, 3000
    if name == "tiny":  # values near 1e-30 (τ0's clamp), and subnormals
        d = (np.abs(rng.normal(size=(2, 2000))) * 1e-30).astype(np.float32)
        d[1, ::3] = 1e-40
        return d, np.array([1e-31, 1e-38], np.float32), 200, 400
    if name == "near_flt_max":  # lo + hi overflows: tree mids of +inf with
        d = rng.uniform(1e38, 3.4e38, size=(6, 2000)).astype(np.float32)  # values
        d[:, :100] = rng.uniform(0.0, 1e37, size=(6, 100))  # above hi: at the first
        # pass's root (rows 0, 2), its right child (row 1), the second pass's
        # third level (row 4: 300 values on hi, the path all right); row 3: hi =
        # dmax; row 5: fewer real entries than T, so lo becomes +inf
        d[4, 100:600] = rng.uniform(1e38, 1.69e38, 500)
        d[4, 600:900] = np.float32(1.703e38)
        d[4, 900:] = rng.uniform(1.75e38, 3.4e38, 1100)
        d[5, 100:] = np.inf
        d[5, :100] = rng.uniform(2e38, 3.4e38, 100)
        tau0 = np.array([2.9e38, 2.2e38, 1.5e38, 4e37, 1.703e38, 1e36], np.float32)
        return d, tau0, 800, 1990
    if name == "inf_nan":  # padding and NaN are never counted
        d = sq(3, 2000)
        d[rng.random(d.shape) < 0.1] = np.inf
        d[rng.random(d.shape) < 0.1] = np.nan
        d[2, :1900] = np.inf  # fewer real entries than T: the ladder undershoots
        return d, seed(np.nan_to_num(d, posinf=0.0), 150), 150, 300
    if name == "T_1":
        d = sq(3, 1000)
        return d, seed(d, 1), 1, 65
    if name == "T_N":
        d = sq(2, 500)
        return d, seed(d, 500), 500, 500
    if name == "N_1":
        return np.array([[2.5]], np.float32), np.array([1.0], np.float32), 1, 1
    if name == "ragged_tiles":  # N not a multiple of the 16,384-element tile
        d = sq(2, 16384 + 4096 + 77)
        return d, seed(d, 900), 900, 1200
    if name == "many_tiles":  # small tiles: the compaction's cross-tile offsets
        d = sq(3, 1500)
        return d, seed(d, 200), 200, 300
    if name in ("undershoot", "overshoot"):  # the seed outside the ladder's reach
        d = sq(2, 800)
        return d, seed(d, 60, 1e-9 if name == "undershoot" else 1e9), 60, 120
    raise KeyError(name)


SCHEDULE_CASES = ["squared_normals", "rung_tie", "tree_tie", "collapsed", "small_integers",
                  "tiny", "near_flt_max", "inf_nan", "T_1", "T_N", "N_1", "ragged_tiles",
                  "many_tiles", "undershoot", "overshoot"]


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_histogram_schedule_matches_serial_bisection(name):
    """Two 7-level histogram passes give ref's 14 serial steps exactly:
    same slots, same values, same counts (tolerance: none)."""
    d, tau0, T, T_pad = _schedule_case(name)
    tile = 64 if name == "many_tiles" else 16384  # select.cu's kTile
    (gv, gi, gc), hazard = _histogram_select(_t(d), _t(tau0), T, T_pad, tile=tile)
    wv, wi, wc = ref.radius_select_kernel(_t(d), _t(tau0), T, T_pad=T_pad)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    np.testing.assert_array_equal(gv.numpy(), wv.numpy())
    np.testing.assert_array_equal(gc.numpy(), wc.numpy())
    if name == "near_flt_max":  # the case reaches what it is named for, in both passes
        assert set().union(*hazard) == {0, 1}


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
# verify_topk: the CUDA kernel's schedule (csrc/verify.cu)
# ---------------------------------------------------------------------------
#
# The CUDA kernel sorts a batch's (query, position) entries by row id with
# a counting sort (count with ranks, scan, scatter), reads each distinct
# row once per group of queries, writes each d² at its (query, position)
# of a (B, max(Tc, k)) buffer of +inf, and answers through topk_smallest.
# This model repeats that schedule step by step; it must give ref's ids
# exactly and its d² to rtol 1e-5 (both sum the difference form, in
# float32, in another order), and read each distinct row once a group.


def _verify_schedule(data, q, cand, k, group):
    """(d² (B, k), ids (B, k), rows read) by csrc/verify.cu's schedule."""
    n, d = data.shape
    B, Tc = cand.shape
    W = max(Tc, k)
    x, qt = _t(data), _t(q)
    dist = np.empty((B, W), np.float32)
    rows_read = 0
    for g0 in range(0, B, group):
        G = min(group, B - g0)
        ids = np.full((G, W), -1, np.int64)
        ids[:, :Tc] = cand[g0:g0 + G]
        ids[(ids < 0) | (ids >= n)] = -1
        e = (g0 + np.arange(G))[:, None] * W + np.arange(W)[None, :]
        ids, e = ids.reshape(-1), e.reshape(-1)
        real = ids >= 0
        dist.reshape(-1)[e[~real]] = np.inf  # padding: +inf for good
        # 1. count: each entry takes the next rank of its row (the atomics'
        # order is any order; here the entries' own)
        counts = np.zeros(n, np.int64)
        rank = np.zeros(ids.size, np.int64)
        for i in np.flatnonzero(real):
            rank[i] = counts[ids[i]]
            counts[ids[i]] += 1
        # 2. scan: each row's offset, and the compact list of non-empty rows
        offset = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows = np.flatnonzero(counts)
        starts = np.append(offset[rows], counts.sum())
        # 3. scatter: each entry at its row's offset plus its rank
        entries = np.full(counts.sum(), -1, np.int64)
        entries[offset[ids[real]] + rank[real]] = e[real]
        assert (entries >= 0).all()  # every slot filled once
        # 4. distance: one read of each non-empty row, d² for its entries
        for j, r in enumerate(rows):
            ent = entries[starts[j]:starts[j + 1]]
            rows_read += 1
            d2 = ((x[r][None, :] - qt[ent // W]) ** 2).sum(-1)
            dist.reshape(-1)[ent] = d2.numpy()
    # 5. answer: the k smallest by (d², position), positions mapped to ids
    vals, sel = ref.topk_smallest(_t(dist), k)
    padded = np.full((B, W), -1, np.int64)
    padded[:, :Tc] = cand
    ids = np.take_along_axis(padded, sel.numpy().astype(np.int64), 1)
    ids = np.where(np.isinf(vals.numpy()), -1, ids)
    return vals.numpy(), ids.astype(np.int32), rows_read


def _verify_schedule_case(name):
    """(data, q, cand, k, group) for the schedule's edges."""
    if name.startswith("existing_"):
        B, n, d, Tc, k, pad = {
            "existing_1": (1, 50, 8, 10, 1, 0), "existing_2": (3, 300, 24, 80, 10, 0),
            "existing_3": (7, 129, 33, 64, 10, 20), "existing_4": (2, 40, 12, 6, 10, 2),
            "existing_5": (4, 513, 96, 200, 1, 0)}[name]
        data, q, cand = _verify_inputs(B, n, d, Tc, pad, seed=B * 100 + n + Tc)
        return data, q, cand, k, 3
    rng = np.random.default_rng(len(name))
    data = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    cand = np.stack([rng.permutation(300)[:40] for _ in range(6)]).astype(np.int32)
    k, group = 10, 4
    if name == "hot_row":  # one row named by every query
        cand[:, 7] = 123
        cand[:, 7 - np.arange(6) % 3] = 123
        cand = np.where((cand == 123) & (np.arange(40)[None] != 7), (cand + 1) % 300, cand)
        cand[:, 7] = 123
    elif name == "duplicates":  # a row twice in one query's list: both entries answer
        q[0] = data[5] + 0.01
        cand[0, [3, 30]] = 5
    elif name == "all_padding":
        cand[2] = -1
        cand[4, 1:] = -1
    elif name == "tc_below_k":
        cand, k = cand[:, :6], 10
        cand[1, 4:] = -1
    elif name == "k_1":
        k = 1
    elif name == "k_128":
        cand = np.stack([rng.permutation(300)[:200] for _ in range(6)]).astype(np.int32)
        k = 128
    elif name == "exact_ties":  # equal rows: the earlier position answers first
        data[9], data[8] = data[3], data[4]
        q[:] = data[3] + 0.01
        cand[:, :4] = [[9, 3, 8, 4]] * 6
        cand[3, :4] = [3, 9, 4, 8]
    elif name == "nan_row":  # NaN d² sorts after +inf and keeps its id
        data[17, 2] = np.nan
        others = np.delete(np.arange(300), 17)
        cand = np.stack([rng.permutation(others)[:40] for _ in range(6)]).astype(np.int32)
        cand[:, 0] = 17
        cand[1, 5:] = -1
        k = 40
    elif name == "one_group":
        group = 6
    return data, q, cand, k, group


VERIFY_SCHEDULE_CASES = ["existing_1", "existing_2", "existing_3", "existing_4", "existing_5",
                         "hot_row", "duplicates", "all_padding", "tc_below_k", "k_1", "k_128",
                         "exact_ties", "nan_row", "one_group"]


@pytest.mark.parametrize("name", VERIFY_SCHEDULE_CASES)
def test_verify_schedule_matches_plain(name):
    """The counting-sort schedule gives ref.verify_topk's ids exactly and
    its d² to rtol 1e-5, and the JAX kernel's (in interpret mode; the
    NaN row aside: the TPU kernel's norm trick answers it otherwise).
    Each distinct row is read once a group of queries."""
    data, q, cand, k, group = _verify_schedule_case(name)
    gv, gi, read = _verify_schedule(data, q, cand, k, group)
    wv, wi = ref.verify_topk(_t(data), _t(q), _t(cand), k)
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_allclose(gv, wv.numpy(), **TOL)
    n = data.shape[0]
    want_read = sum(np.unique(c[(c >= 0) & (c < n)]).size
                    for c in np.split(cand, range(group, cand.shape[0], group)))
    assert read == want_read
    if name != "nan_row":
        pv, pi = verify_topk_pallas(jnp.asarray(data), jnp.asarray(q), jnp.asarray(cand), k,
                                    interpret=True)
        np.testing.assert_array_equal(gi, np.asarray(pi))
        np.testing.assert_allclose(gv, np.asarray(pv), **TOL)
    if name == "duplicates":
        assert gi[0, :2].tolist() == [5, 5]
    if name == "nan_row":
        assert np.isnan(gv[0]).sum() == 1 and gi[0][np.isnan(gv[0])].tolist() == [17]
    if name == "hot_row":
        assert read < sum(np.unique(c[c >= 0]).size for c in cand)  # 123 once a group


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
# topk_smallest: the CUDA kernel's threshold-filter schedule (csrc/topk.cu)
# ---------------------------------------------------------------------------
#
# Each block reads its split in chunks, keys (value bits made monotone,
# column) compared with a threshold as they are read; only keys at or
# below it enter the buffer, which is sorted when it could not take
# another chunk and at the split's end.  This model repeats the schedule
# with the kernel's constants (and with smaller ones, so that small rows
# cross several chunks and splits) and must agree with ref.topk_smallest
# bit for bit.

_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def _topk_keys(v):
    """topk.cu's topk_key over a float32 row: (monotone bits, column)."""
    bits = v.view(np.uint32).copy()
    bits[bits == 0x80000000] = 0  # −0.0 ties with +0.0
    bits = np.where(bits & 0x80000000, ~bits, bits | np.uint32(0x80000000))
    bits[np.isnan(v)] = 0xFFFFFFFF  # NaN after +inf
    return (bits.astype(np.uint64) << np.uint64(32)) | np.arange(v.size, dtype=np.uint64)


def _topk_split(keys, k, threads, per, stats):
    """One block's loop over its split's keys: the k smallest, padded."""
    chunk = threads * per
    buf, thr = [], _PAD
    for base in range(0, keys.size, chunk):
        c = np.full(chunk, _PAD, np.uint64)
        c[:min(chunk, keys.size - base)] = keys[base:base + chunk]
        if base == 0 and keys.size > threads:  # k-th of the threads' minima
            thr = np.sort(c.reshape(per, threads).min(0))[k - 1]
        kept = c[(c <= thr) & (c != _PAD)]
        buf.extend(kept.tolist())
        assert len(buf) <= 2 * chunk  # the shared buffer never overflows
        if len(buf) > chunk or base + chunk >= keys.size:
            stats["sorted"] += len(buf)
            buf = sorted(buf)[:k]
            if len(buf) == k:
                thr = np.uint64(buf[k - 1])
    return np.array(buf + [int(_PAD)] * (k - len(buf)), np.uint64)


def _topk_schedule(d, k, *, threads=256, per=8, split_min=8192, wave=1056):
    """(values, indices, stats) by topk.cu's grid: S splits of a row, then
    the same loop over the S·k partial keys."""
    B, N = d.shape
    S = min(-(-N // split_min), max(1, wave // B))
    R = max(-(-N // S), min(split_min, N))
    S = -(-N // R)
    stats = {"sorted": 0, "keys": B * N}
    vals = np.empty((B, k), np.float32)
    idx = np.empty((B, k), np.int32)
    for b in range(B):
        keys = _topk_keys(d[b])
        parts = [_topk_split(keys[s * R:(s + 1) * R], k, threads, per, stats) for s in range(S)]
        final = parts[0] if S == 1 else _topk_split(np.concatenate(parts), k, threads, per,
                                                    stats)
        assert (final != _PAD).all()
        cols = (final & np.uint64(0xFFFFFFFF)).astype(np.int64)
        vals[b], idx[b] = d[b, cols], cols
    return vals, idx, stats


def _topk_schedule_case(name):
    """(d, k, small): small runs the model with 32 threads of 4 keys and
    splits of 256, so short rows cross chunks and splits."""
    rng = np.random.default_rng(len(name) + 7)
    if name == "ascending":
        return np.sort(rng.random((3, 3000)).astype(np.float32), 1), 10, True
    if name == "descending":  # every key enters the buffer
        return -np.sort(-rng.random((3, 3000)).astype(np.float32), 1), 10, True
    if name == "all_equal":
        return np.full((2, 2000), 3.0, np.float32), 16, True
    if name == "few_finite":
        d = np.full((3, 1500), np.inf, np.float32)
        d[0, [700, 3]] = [2.0, 1.0]
        d[1, ::100] = rng.random(15).astype(np.float32)
        return d, 20, True
    if name == "signed_zeros":
        d = rng.random((2, 1200)).astype(np.float32)
        d[0, ::7] = 0.0
        d[0, 3::11] = -0.0
        d[1, 5::13] = -0.0
        return d, 32, True
    if name == "nan_inf":
        d = rng.random((3, 1000)).astype(np.float32)
        d[0, ::3] = np.nan
        d[1, :990] = np.nan
        d[1, 995:] = np.inf
        d[2, ::2] = np.inf
        return d, 12, True
    if name == "k_1":
        return (rng.normal(size=(4, 2000)) ** 2).astype(np.float32), 1, True
    if name == "k_128":
        return (rng.normal(size=(2, 20000)) ** 2).astype(np.float32), 128, False
    if name == "over_one_buffer":  # the kernel's own constants: N just past a split
        return (rng.normal(size=(2, 8192 + 3)) ** 2).astype(np.float32), 10, False
    if name == "merge_shape":  # the stream merge's (B, tens): one split, no minima
        return rng.random((5, 47)).astype(np.float32), 10, False
    raise KeyError(name)


TOPK_SCHEDULE_CASES = ["ascending", "descending", "all_equal", "few_finite", "signed_zeros",
                       "nan_inf", "k_1", "k_128", "over_one_buffer", "merge_shape"]


@pytest.mark.parametrize("name", TOPK_SCHEDULE_CASES)
def test_topk_threshold_schedule_matches_sort(name):
    """The threshold filter and its sorts give the stable sort's answer
    bit for bit (ref, and the JAX oracle but where −0.0 and +0.0 meet:
    lax.top_k puts −0.0 first, the stable sort ties them); on an
    ascending row almost no key reaches a sort."""
    d, k, small = _topk_schedule_case(name)
    consts = dict(threads=32, per=4, split_min=256, wave=16) if small else {}
    gv, gi, stats = _topk_schedule(d, k, **consts)
    wv, wi = ref.topk_smallest(_t(d), k)
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gv.view(np.int32), wv.numpy().view(np.int32))
    jv, ji = jref.topk_smallest(d, k)
    if name == "signed_zeros":
        assert not np.array_equal(gi, np.asarray(ji))  # the deviation, ROADMAP §C
        assert (np.asarray(jv) == gv).all()  # the same values, −0.0 == +0.0
    else:
        np.testing.assert_array_equal(gi, np.asarray(ji))
    if name == "ascending":
        assert stats["sorted"] < stats["keys"] / 10
    if name == "descending":
        assert stats["sorted"] > stats["keys"] / 2


# ---------------------------------------------------------------------------
# pair_join: the schedule of csrc/pair_join.cu
# ---------------------------------------------------------------------------
#
# One cooperative launch plans each group of bands under the ub² at its
# start (the candidate tiles, in traversal order: one band while the heap
# is not full, else bands until the group lists `target` tiles, spans
# `max_bands` bands or meets a band that lists none), computes each
# candidate's top-k by threshold (the k-th smallest of the threads' least
# (d², position) keys; only keys at or below it and below the group's
# first ub² are buffered and sorted), and folds the group in order, `warp`
# tiles a ballot, merging by rank.  This model repeats the schedule on the
# plain version's tile d², with the kernel's constants (256 threads of
# 8 × 8 pairs, a warp of 32, 8 tiles a block of the H100's 264-block
# grid, 512 bands a group) and with small ones, and must agree with
# ref.pair_join bit for bit: d², pairs and counters.

_PJ_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
_PJ_KERNEL = dict(warp=32, target=8 * 264, side=16, max_bands=512)
_PJ_SMALL = dict(warp=4, target=3, side=4, max_bands=2)


def _pj_pruned(gap, thresh2, ub2):
    """The skip test in double, as ref's host loop and the kernel make it."""
    return gap > 0.0 and gap * gap > thresh2 * ub2


def _pj_gap(key, n, bN, i, j):
    return float(np.float32(key[j * bN] - key[min((i + 1) * bN, n) - 1]))


def _pj_plan(key, n, bN, n_ti, b, ub2, thresh2, target, max_bands):
    """plan_group: [(band, [(i, gap), ...]), ...] and the band after it."""
    group, total = [], 0
    while b < n_ti:
        cands = [(i, g) for i in range(n_ti - b)
                 for g in [_pj_gap(key, n, bN, i, i + b)] if not _pj_pruned(g, thresh2, ub2)]
        group.append((b, cands))
        total += len(cands)
        b += 1
        if not cands or not ub2 < np.inf or total >= target or len(group) == max_bands:
            break
    return group, b


def _pj_tile_topk(d2, si, sj, ub2, k, side, stats):
    """join_tile's top-k of one tile: (d² (k,), position (k,)), the
    positions row·128 + col, (+inf, INT_MAX) past the pairs below ub2."""
    mi, mj = d2.shape
    full = np.full((128, 128), np.inf, np.float32)
    full[:mi, :mj] = d2
    rows, cols = np.arange(128)[:, None], np.arange(128)[None, :]
    ok = (rows < mi) & (cols < mj) & (sj + cols > si + rows) & (full < np.float32(ub2))
    pos = (rows * 128 + cols).astype(np.uint64)
    keys = np.where(ok, (full.view(np.uint32).astype(np.uint64) << np.uint64(32)) | pos, _PJ_PAD)
    # thread (ty, tx) holds the rows ty + side·u and the columns tx + side·v
    least = keys.reshape(128 // side, side, 128 // side, side).min(axis=(0, 2)).ravel()
    thr = np.sort(least)[k - 1] if k <= least.size else _PJ_PAD
    buf = keys[(keys <= thr) & (keys != _PJ_PAD)]
    assert buf.size <= (128 // side) ** 2 * k  # the buffer's bound: 64·k at the kernel's side
    stats["buffered"].append(buf.size)
    top = np.sort(buf)[:k]
    v = np.full(k, np.inf, np.float32)
    p = np.full(k, 2**31 - 1, np.int64)
    v[:top.size] = (top >> np.uint64(32)).astype(np.uint32).view(np.float32)
    p[:top.size] = (top & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return v, p


def _pj_merge(heap, tv, tp, i, b, bN, k):
    """merge_tile: ranks by count_below / count_at_most, heap first on ties."""
    hv, hi, hj = heap
    nv, ni, nj = hv.copy(), hi.copy(), hj.copy()
    for e in range(k):
        ra = e + int(np.searchsorted(tv, hv[e], side="left"))
        if ra < k:
            nv[ra], ni[ra], nj[ra] = hv[e], hi[e], hj[e]
        rb = e + int(np.searchsorted(hv, tv[e], side="right"))
        if rb < k:
            real = tp[e] != 2**31 - 1
            nv[rb] = tv[e]
            ni[rb] = i * bN + tp[e] // 128 if real else -1
            nj[rb] = (i + b) * bN + tp[e] % 128 if real else -1
    return nv, ni, nj


def _pj_schedule(xs, ks, k, thresh2, *, warp, target, side, max_bands):
    """(d², pi, pj, [pairs_verified, tiles_pruned, bands_joined], stats)
    by the kernel's schedule."""
    x = torch.from_numpy(xs)
    norms = (x * x).sum(1)
    n = xs.shape[0]
    bN = ref._pair_join_block(n)
    n_ti = -(-n // bN)
    heap = (np.full(k, np.inf, np.float32), np.full(k, -1, np.int64), np.full(k, -1, np.int64))
    pairs = pruned = bands = 0
    stats = {"buffered": [], "band0_buffered": [], "merge_lanes": set(), "groups": 0,
             "tiles": 0}
    b, stop = 0, False
    while not stop:
        ub2 = float(heap[0][k - 1])
        group, b = _pj_plan(ks, n, bN, n_ti, b, ub2, thresh2, target, max_bands)
        stats["groups"] += 1
        tops = {}
        for bb, cands in group:
            for i, _ in cands:
                si, sj = i * bN, (i + bb) * bN
                ei, ej = min(si + bN, n), min(sj + bN, n)
                d2 = torch.clamp_min(norms[si:ei, None] + norms[None, sj:ej]
                                     - 2.0 * (x[si:ei] @ x[sj:ej].T), 0.0).numpy()
                tops[bb, i] = _pj_tile_topk(d2, si, sj, ub2, k, side, stats)
                stats["tiles"] += 1
                if bb == 0:
                    stats["band0_buffered"].append(stats["buffered"][-1])
        for bb, cands in group:  # fold_group
            pruned += (n_ti - bb) - len(cands)
            joined = 0
            for c0 in range(0, len(cands), warp):
                chunk = cands[c0:c0 + warp]
                start = 0
                while True:
                    ub2_now = float(heap[0][k - 1])
                    pr = [_pj_pruned(g, thresh2, ub2_now) for _, g in chunk]
                    first = next((lane for lane in range(start, len(chunk))
                                  if not pr[lane] and tops[bb, chunk[lane][0]][0][0] < ub2_now),
                                 None)
                    last = len(chunk) - 1 if first is None else first
                    for lane in range(start, last + 1):
                        if pr[lane]:
                            pruned += 1
                        else:
                            joined += 1
                            i = chunk[lane][0]
                            mi, mj = min(bN, n - i * bN), min(bN, n - (i + bb) * bN)
                            pairs += mi * (mi - 1) // 2 if bb == 0 else mi * mj
                    if first is None:
                        break
                    i = chunk[first][0]
                    heap = _pj_merge(heap, *tops[bb, i], i, bb, bN, k)
                    stats["merge_lanes"].add(first)
                    start = first + 1
            if joined == 0:  # the stop band: every later tile is pruned
                rest = n_ti - bb - 1
                pruned += rest * (rest + 1) // 2
                stop = True
                break
            bands += 1
        stop = stop or b >= n_ti
    return (heap[0], heap[1].astype(np.int32), heap[2].astype(np.int32),
            [pairs, pruned, bands], stats)


def _pj_case(name):
    """(xs, ks, k, thresh2): rows sorted by key."""
    rng = np.random.default_rng(len(name) + 11)

    def sorted_rows(x):
        key = (x @ rng.normal(size=(x.shape[1],))).astype(np.float32)
        order = np.argsort(key, kind="stable")
        return x[order], key[order]

    if name == "two_far_clusters":
        x = np.concatenate([rng.normal(size=(256, 8)),
                            rng.normal(size=(256, 8)) + 500.0]).astype(np.float32)
        order = np.argsort(x[:, 0], kind="stable")
        return x[order], x[order, 0].copy(), 10, 16.0
    if name == "merge_lanes":  # band 1 lists 33 tiles: a ballot of 32, then one
        x = rng.normal(size=(34 * 128, 4)).astype(np.float32)
        x = x[np.argsort(x[:, 0], kind="stable")]
        for row in (32 * 128, 33 * 128):  # near-duplicates across tiles (31, 32), (32, 33)
            x[row] = x[row - 1] + np.float32(1e-3)
        return x, x[:, 0].copy(), 10, np.inf
    if name == "ties":  # small integers: exact d², equal within and across tiles
        return (*sorted_rows(rng.integers(0, 3, size=(600, 3)).astype(np.float32)), 20, 16.0)
    n, d, k, t2 = {"band0_inf": (1200, 16, 10, 16.0), "fewer_pairs_than_k": (4, 6, 10, np.inf),
                   "k_1": (513, 8, 1, 9.0), "k_128": (1000, 16, 128, 16.0),
                   "thresh2_0": (700, 16, 10, 0.0), "thresh2_inf": (400, 8, 10, np.inf),
                   "stop_band": (3000, 8, 10, 4.0), "ragged": (513, 24, 16, 16.0),
                   "n_below_128": (100, 12, 5, 9.0)}[name]
    return (*sorted_rows(rng.normal(size=(n, d)).astype(np.float32)), k, t2)


PAIR_JOIN_SCHEDULE_CASES = ["band0_inf", "merge_lanes", "ties", "fewer_pairs_than_k", "k_1",
                            "k_128", "thresh2_0", "thresh2_inf", "stop_band", "ragged",
                            "two_far_clusters", "n_below_128"]


@pytest.mark.parametrize("name", PAIR_JOIN_SCHEDULE_CASES)
def test_pair_join_schedule_matches_serial_sweep(name):
    """Group-start ub², threshold top-k and the 32-tile ballot fold give
    ref.pair_join's answer and counters bit for bit, with the kernel's
    constants and with small ones."""
    xs, ks, k, t2 = _pj_case(name)
    wv, wi, wj, ws = (t.numpy() for t in ref.pair_join(_t(xs), _t(ks), k, thresh2=t2))
    n_ti = -(-xs.shape[0] // ref._pair_join_block(xs.shape[0]))
    for consts in (_PJ_KERNEL, _PJ_SMALL):
        gv, gi, gj, gs, stats = _pj_schedule(xs, ks, k, t2, **consts)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gj, wj)
        assert gs == ws.tolist()
        if consts is _PJ_KERNEL:
            # band 0 (ub² = +inf) buffers about k keys a tile, not the tile
            assert np.mean(stats["band0_buffered"]) <= 4 * k
            if name == "merge_lanes":
                assert {0, 31} <= stats["merge_lanes"]
            if name == "stop_band":
                assert ws[2] < n_ti - 1 and stats["groups"] > 1
            if name == "ties":
                assert (wv[1:] == wv[:-1]).any()


# ---------------------------------------------------------------------------
# project_dist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,N,d,m", [(5, 700, 200, 15), (1, 1030, 130, 16), (7, 64, 33, 20),
                                     (3, 501, 64, 32)])
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
