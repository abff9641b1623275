"""CI gate for the repro_torch.index facade: the PyTorch port's twin of
``scripts/check_api.py``, on the card by default.

Imports every registered backend, builds it over a seeded 256×32
dataset, runs one batched ANN search (and one cp_search where the
backend is CP-capable), and asserts the uniform contract: (B, k) int32
indices / float32 distances, true original-space distances, WorkStats
attached.  "stream"-capable backends additionally get a mutation
conformance pass: insert→search visibility (before AND after flush),
delete→absence (before and after compaction-inducing churn), and live
count accounting.

A quant conformance gate then sweeps every quantized path (flat+sq8,
flat+pq, flat-pq, codes-only, streaming with quantized segments):
encode→search recall on the fixed seed must stay within a floor of the
float32 flat backend, the SearchResult padding invariants (-1 indices
/ +inf distances, int32/float32) must hold — exercised with k > n —
and quantized storage must actually be smaller than float32.

A CP conformance gate keeps the "cp" capability honest: every backend
advertising it must return SORTED, EXACT-VERIFIED pairs (ascending
distances that match a recomputation from the raw rows, i < j, no
duplicates, full recall of the unambiguous seeded closest pair) with
weakly k-monotone WorkStats pair accounting.

A serve conformance gate runs the request scheduler (DESIGN.md §11)
over a ragged mixed-k trace against a streaming datastore: every ok
response must match a direct facade search, shed accounting must sum
to the submitted count, compile counters must match the executed shape
set, and the SQ8 hot-query cache must invalidate across extend/evict.

A sharded conformance gate (DESIGN.md §15) holds the sharded-flat
backend to BIT-IDENTICAL ANN and CP answers vs flat at shard counts
{1,2,4,8} (mesh path when enough devices are visible, the emulated
twin otherwise), a recall floor for sharded-flat-pq vs flat-pq, and
shard-summed WorkStats equal to flat's totals.  Exits non-zero naming
each failed gate.

    PYTHONPATH=src python scripts/torch_check_api.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device

# the reference gate's force="ref" (its jnp oracles): the port's
# sharded backends read ``force``, flat and flat-pq ``use_kernels``;
# both name the kernels' plain versions
PLAIN = {"force": "ref", "use_kernels": False}


def check_stream(index, data, rng) -> None:
    """Mutation conformance for a "stream"-capable backend."""
    from repro_torch.index import MutableIndex

    assert isinstance(index, MutableIndex), "missing insert/delete/flush"
    n_before = index.n
    d = data.shape[1]
    # insert → visibility: a far-off cluster must come back as its ids
    probe = np.full((1, d), 37.0, dtype=np.float32)
    new = index.insert(probe + rng.normal(size=(3, d)).astype(np.float32)
                       * 0.01)
    assert len(new) == 3 and index.n == n_before + 3
    res = index.search(probe, 3)
    assert set(res.indices[0].tolist()) == set(int(i) for i in new), (
        f"inserted ids {new.tolist()} not visible: {res.indices[0]}")
    # delete → absence (still in the delta)
    assert index.delete(new[:1]) == 1
    assert int(new[0]) not in index.search(probe, 5).indices
    # flush → still visible / still absent
    index.flush()
    res = index.search(probe, 2)
    assert set(res.indices[0].tolist()) == set(int(i) for i in new[1:])
    # delete sealed rows, then churn through flush/compaction cycles
    assert index.delete(new[1:]) == 2
    for _ in range(4):
        index.insert(rng.normal(size=(64, d)).astype(np.float32))
        index.flush()
    res = index.search(probe, 10)
    for i in new:
        assert int(i) not in res.indices, f"tombstoned id {i} returned"
    assert index.delete(new) == 0  # re-delete is a no-op


def _recall(res, exact_ids) -> float:
    return float(np.mean([
        len(set(row.tolist()) & set(ex.tolist())) / len(ex)
        for row, ex in zip(res.indices, exact_ids)
    ]))


def _assert_result_invariants(res, n: int, B: int, k: int) -> None:
    """The (B, k) dtype + padding contract, on any quantized path."""
    assert res.indices.shape == res.distances.shape == (B, k)
    assert res.indices.dtype == np.int32, res.indices.dtype
    assert res.distances.dtype == np.float32, res.distances.dtype
    valid = res.indices >= 0
    assert valid.any(), "no results returned"
    assert (res.indices[valid] < n).all(), "index out of range"
    assert np.isfinite(res.distances[valid]).all()
    assert (res.distances[~valid] == np.inf).all(), "padding must be +inf"
    # distances ascend within each row's valid prefix
    for b in range(B):
        dv = res.distances[b][valid[b]]
        assert (np.diff(dv) >= -1e-5).all(), "distances not sorted"


def check_quant(data, queries, rng, device) -> None:
    """Quant gate: recall within a floor of float32 flat + the padding
    invariants + a real storage reduction, on every quantized path."""
    from repro_torch.index import IndexConfig, build_index

    n = len(data)
    B, k = queries.shape[0], 10
    exact = np.argsort(
        np.linalg.norm(data[None] - queries[:, None], axis=-1), axis=1
    )[:, :k]
    flat = build_index(data, IndexConfig(backend="flat", seed=0), device=device)
    ref_recall = _recall(flat.search(queries, k), exact)
    f32_bytes = flat.bytes_per_point()

    paths = [
        ("flat+sq8", IndexConfig(backend="flat", seed=0,
                                 options={"quant": "sq8", "rerank": 64}),
         0.05),
        ("flat+pq", IndexConfig(backend="flat", seed=0,
                                options={"quant": "pq", "rerank": 64,
                                         "pq": {"m_codebooks": 8}}),
         0.05),
        ("flat-pq", IndexConfig(backend="flat-pq", seed=0), 0.05),
        ("codes-only", IndexConfig(backend="flat", seed=0,
                                   options={"quant": "sq8", "rerank": 64,
                                            "store_raw": False}),
         0.15),
    ]
    for name, cfg, floor in paths:
        index = build_index(data, cfg, device=device)
        res = index.search(queries, k)
        _assert_result_invariants(res, n, B, k)
        rec = _recall(res, exact)
        assert rec >= ref_recall - floor, (
            f"{name}: recall {rec:.3f} below flat {ref_recall:.3f} - {floor}")
        assert index.bytes_per_point() < f32_bytes, (
            f"{name}: no storage reduction")
        # k > n exercises the padding path end-to-end
        _assert_result_invariants(index.search(queries[:2], n + 7),
                                  n, 2, n + 7)

    # streaming with quantized sealed segments: the same mutation
    # conformance every "stream" backend passes, over quantized storage
    stream = build_index(
        data, IndexConfig(backend="streaming", seed=0,
                          options={"quant": "sq8", "delta_threshold": 64,
                                   "max_segments": 3}), device=device)
    assert stream.segments and all(
        s.backend == "flat" for s in stream.segments)
    check_stream(stream, data, rng)
    print(f"  ok   quant gate    [recall floor vs flat={ref_recall:.3f}, "
          f"padding, streaming-quant]")


def check_serve(data, rng, device) -> None:
    """Serve gate (DESIGN.md §11): submit→response correctness under
    ragged traffic, shed accounting summing to the submitted count, and
    cache invalidation across streaming mutations."""
    from repro_torch.index import IndexConfig
    from repro_torch.serve import RequestScheduler, ServeConfig
    from repro_torch.serve.serve_step import make_retrieval_step

    step, _ = make_retrieval_step(
        data, np.arange(len(data)), k=8,
        index_config=IndexConfig(backend="streaming", seed=0,
                                 options={"delta_threshold": 64}),
        device=device)
    # cache OFF for the correctness trace: the SQ8 cache intentionally
    # answers near-duplicate queries (same grid cell) from one entry,
    # which is approximation by design, not a routing bug
    sched = RequestScheduler(step, config=ServeConfig(
        b_max=8, k_max=16, max_queue=6, watermark=0.5, cache=False,
        shed_policy="shed", default_deadline_ms=1e6))

    # ragged trace: mixed k, bursty submits, occasional drains — every
    # ok response must answer ITS query exactly as a direct facade
    # search at the bucket's padded k would
    trace = []
    for i in range(120):
        kq = int(rng.choice([1, 3, 5, 12]))
        q = (data[int(rng.integers(0, len(data)))]
             + rng.normal(size=data.shape[1]).astype(np.float32) * 0.01)
        trace.append((q, kq, sched.submit(q, k=kq)))
        if i % 9 == 8:
            sched.drain()
    sched.drain()
    ok = shed = 0
    for q, kq, t in trace:
        resp = t.result()
        if resp.status == "shed":
            shed += 1
            continue
        ok += 1
        assert resp.result.indices.shape == (1, kq), resp.result.indices.shape
        assert resp.valid.shape == (1, kq)
        assert np.isfinite(resp.distances).all(), "unneutralized padding"
        direct = step.index.search(q[None], sched.palette.k_pad(kq))
        np.testing.assert_array_equal(
            resp.result.indices, direct.indices[:, :kq],
            err_msg="scheduler response != direct facade search")
    snap = sched.snapshot()
    assert ok + shed == len(trace), "lost a ticket"
    assert snap.submitted == snap.completed + snap.shed == len(trace), (
        f"shed accounting broken: {snap.submitted} submitted, "
        f"{snap.completed} completed, {snap.shed} shed")
    assert snap.submitted == (snap.completed + snap.shed + snap.failed
                              + snap.pending), (
        "full accounting identity broken: submitted != "
        "completed + shed + failed + pending")
    assert snap.compile_misses == len(sched.compile_shapes), (
        "compile counter diverged from executed shapes")

    # cache invalidation across extend/evict (streaming mutation) — a
    # fresh scheduler with the cache on
    sched = RequestScheduler(step, config=ServeConfig(
        b_max=8, default_deadline_ms=1e6))
    probe = np.full((data.shape[1],), 29.0, np.float32)
    sched.submit(probe, k=2).result()
    assert sched.submit(probe, k=2).result().cached, "hot query missed"
    ids = sched.extend(probe[None], [4242])
    post = sched.submit(probe, k=2).result()
    assert not post.cached, "cache served across extend"
    assert post.result.indices[0, 0] == ids[0], "fresh insert not returned"
    sched.evict(ids)
    gone = sched.submit(probe, k=2).result()
    assert not gone.cached, "cache served across evict"
    assert ids[0] not in gone.result.indices, "tombstoned id returned"
    print(f"  ok   serve gate    [ragged {len(trace)}-req trace: "
          f"{ok} ok / {shed} shed, {snap.compile_misses} compiles, "
          "cache invalidation]")


def check_quality(data, rng, device) -> None:
    """Quality gate (DESIGN.md §13): the shadow auditor's online recall
    equals an offline ground-truth replay of the same served answers,
    the accounting identity ``audited == sampled − pending`` holds at
    every stage (including under queue overflow, which refuses the
    sample rather than breaking the books), and the Lemma-3 coverage
    audit actually scored pairs."""
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quality import QualityAuditor

    index = build_index(data, IndexConfig(backend="flat", seed=0), device=device)
    reg = MetricsRegistry()  # private: the gate must not pollute global
    auditor = QualityAuditor.for_index(
        index, sample_fraction=1.0, seed=0, registry=reg)

    k = 5
    queries = (data[rng.integers(0, len(data), 64)]
               + rng.normal(size=(64, data.shape[1])).astype(np.float32)
               * 0.01)
    served = index.search(queries, k)
    for q, ids, dd in zip(queries, served.indices, served.distances):
        assert auditor.maybe_sample(q, ids, dd), "fraction=1.0 must sample"
    assert auditor.sampled == len(queries)
    # the identity holds mid-flight, not just at drain
    auditor.audit(max_items=10)
    assert auditor.audited == 10 and auditor.pending == len(queries) - 10
    assert auditor.audited == auditor.sampled - auditor.pending
    auditor.audit()
    rep = auditor.report()
    assert rep.pending == 0 and rep.audited == len(queries)

    # offline ground-truth replay: same served rows, same truth
    recalls = []
    for q, ids in zip(queries, served.indices):
        truth = np.argsort(np.linalg.norm(data - q, axis=-1))[:k]
        recalls.append(len(set(ids.tolist()) & set(truth.tolist())) / k)
    offline = float(np.mean(recalls))
    assert abs(rep.recall - offline) < 1e-9, (
        f"auditor recall {rep.recall} != offline ground truth {offline}")
    assert rep.ratio >= 1.0 - 1e-6, f"ratio {rep.ratio} below 1"
    assert rep.coverage_pairs > 0, "coverage audit scored no pairs"

    # overflow refuses the SAMPLE; the books stay balanced
    small = QualityAuditor.for_index(
        index, sample_fraction=1.0, seed=0, max_pending=4, registry=reg)
    for q, ids, dd in zip(queries[:12], served.indices[:12],
                          served.distances[:12]):
        small.maybe_sample(q, ids, dd)
    assert small.sampled == 4 and small.overflowed == 8, (
        small.sampled, small.overflowed)
    assert small.audited == small.sampled - small.pending == 0
    small.audit()
    assert small.audited == small.sampled == 4 and small.pending == 0
    print(f"  ok   quality gate  [{len(queries)}-query audit == offline "
          "truth, accounting identity under overflow, "
          f"{rep.coverage_pairs} coverage pairs]")


def check_cp(data, rng, device) -> None:
    """Capability-honest CP gate over every backend advertising "cp"."""
    from repro_torch.index import IndexConfig, available_backends, build_index

    # plant one unambiguous closest pair so recall@1 is well-defined
    # for every backend regardless of its approximation ratio
    data = np.array(data, copy=True)
    data[7] = data[3] + 1e-3 * rng.normal(size=data.shape[1]).astype(
        np.float32)
    for backend in available_backends("cp"):
        index = build_index(data, IndexConfig(backend=backend, seed=0),
                            device=device)
        prev_verified = -1
        for k in (1, 3, 6):
            res = index.cp_search(k)
            p, d = res.pairs, res.distances
            assert p.dtype == np.int32 and d.dtype == np.float32, backend
            assert p.shape == (len(d), 2) and len(d) <= k, (
                f"{backend}: shape {p.shape} for k={k}")
            assert len(d) >= 1, f"{backend}: no pairs returned"
            assert (p[:, 0] != p[:, 1]).all(), f"{backend}: self-pair"
            keys = {tuple(sorted(r)) for r in p.tolist()}
            assert len(keys) == len(p), f"{backend}: duplicate pair"
            assert (np.diff(d) >= -1e-5).all(), (
                f"{backend}: distances not sorted: {d}")
            # exact-verified: returned distances match the raw rows
            true = np.linalg.norm(data[p[:, 0]] - data[p[:, 1]], axis=-1)
            np.testing.assert_allclose(
                d, true, rtol=1e-3, atol=1e-4,
                err_msg=f"{backend}: distances not exact-verified")
            assert tuple(sorted(p[0])) == (3, 7), (
                f"{backend}: missed the planted closest pair, got {p[0]}")
            # pair accounting: weakly monotone in k (the radius filter's
            # ub only widens with k; exhaustive backends report a
            # constant), and the new counters are self-consistent
            verified = res.stats.pairs_verified
            assert verified >= prev_verified, (
                f"{backend}: pairs_verified not monotone in k "
                f"({prev_verified} -> {verified})")
            prev_verified = verified
            assert res.stats.tiles_pruned >= 0
    print(f"  ok   cp gate       [{len(available_backends('cp'))} backends: "
          "sorted exact-verified pairs, monotone pair accounting]")


def check_sharded(data, queries, rng, device) -> None:
    """Sharded conformance gate (DESIGN.md §15): the sharded-flat
    backend must be BIT-IDENTICAL to flat (ANN and CP) at every shard
    count — the counts-only threshold exchange plus the canonical
    ``answer_distances`` recomputation make exactness, not recall, the
    contract — sharded-flat-pq must hold a recall floor vs flat-pq, and
    the per-shard WorkStats must sum to flat's totals with a sane skew
    field.  Shard counts above the visible device count run on the
    emulated twin (bit-identical to the mesh path by construction)."""
    from repro_torch.index import IndexConfig, build_index

    n, k = len(data), 5
    B = queries.shape[0]
    flat = build_index(data, IndexConfig(backend="flat", seed=0,
                                         options=PLAIN), device=device)
    rf = flat.search(queries, k)
    cf = flat.cp_search(4)
    shard_counts = sorted({1, 2, 4, 8})
    for P in shard_counts:
        idx = build_index(data, IndexConfig(
            backend="sharded-flat", seed=0,
            options={"shards": P, **PLAIN}), device=device)
        rs = idx.search(queries, k)
        np.testing.assert_array_equal(
            rf.indices, rs.indices,
            err_msg=f"sharded-flat P={P}: ANN ids diverge from flat")
        np.testing.assert_array_equal(
            rf.distances, rs.distances,
            err_msg=f"sharded-flat P={P}: ANN distances not bit-identical")
        cs = idx.cp_search(4)
        np.testing.assert_array_equal(
            cf.pairs, cs.pairs,
            err_msg=f"sharded-flat P={P}: CP pairs diverge from flat")
        np.testing.assert_array_equal(
            cf.distances, cs.distances,
            err_msg=f"sharded-flat P={P}: CP distances not bit-identical")
        # per-shard accounting: totals match flat, skew bounded by total
        assert rs.stats.shards == P, rs.stats.shards
        assert rs.stats.candidates_selected == rf.stats.candidates_selected, (
            f"P={P}: shard-summed candidate count "
            f"{rs.stats.candidates_selected} != flat "
            f"{rf.stats.candidates_selected}")
        assert 0 < rs.stats.max_shard_candidates <= (
            rs.stats.candidates_selected), "skew field out of bounds"
        assert cs.stats.max_shard_pairs <= cs.stats.pairs_verified
        _assert_result_invariants(rs, n, B, k)

    # quantized sharded path: per-shard codebooks, shard-local ADC
    # rerank — approximate by design, so a recall floor vs flat-pq
    exact = np.argsort(
        np.linalg.norm(data[None] - queries[:, None], axis=-1), axis=1
    )[:, :k]
    fpq = build_index(data, IndexConfig(backend="flat-pq", seed=0,
                                        options=PLAIN), device=device)
    ref = _recall(fpq.search(queries, k), exact)
    spq = build_index(data, IndexConfig(
        backend="sharded-flat-pq", seed=0,
        options={"shards": max(shard_counts), **PLAIN}), device=device)
    rq = spq.search(queries, k)
    rec = _recall(rq, exact)
    assert rec >= 0.95 * ref, (
        f"sharded-flat-pq recall {rec:.3f} < 0.95× flat-pq {ref:.3f}")
    assert spq.bytes_per_point() < flat.bytes_per_point(), (
        "sharded-flat-pq: no storage reduction")
    _assert_result_invariants(rq, n, B, k)
    mode = ("mesh" if visible_devices() >= max(shard_counts)
            else "emulated>" + str(visible_devices()))
    print(f"  ok   sharded gate  [P={shard_counts} bit-identical ANN+CP, "
          f"pq recall {rec:.3f} vs flat-pq {ref:.3f}, stats sum+skew; "
          f"{mode}]")


def visible_devices() -> int:
    """The visible CUDA devices (1 on the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    from repro_torch.index import (
        CpSearchResult,
        IndexConfig,
        SearchResult,
        available_backends,
        backend_capabilities,
        build_index,
    )

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 32)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 8, 256)]
            + rng.normal(size=(256, 32)).astype(np.float32) * 0.5)
    queries = data[:4] + 0.05
    B, k = 4, 5

    failures = []
    for backend in available_backends():
        caps = backend_capabilities(backend)
        t0 = time.perf_counter()
        try:
            index = build_index(data, IndexConfig(backend=backend, seed=0),
                                device=device)
            checked = []
            if "ann" in caps:
                res = index.search(queries, k)
                assert isinstance(res, SearchResult)
                assert res.indices.shape == (B, k), res.indices.shape
                assert res.distances.shape == (B, k), res.distances.shape
                assert res.indices.dtype == np.int32
                assert res.distances.dtype == np.float32
                valid = res.indices >= 0
                assert valid.any(), "no results returned"
                for b in range(B):
                    for i, d in zip(res.indices[b], res.distances[b]):
                        if i < 0:
                            continue
                        true = np.linalg.norm(data[i] - queries[b])
                        assert abs(d - true) <= 1e-3 * max(true, 1.0), (
                            f"distance {d} != true {true}"
                        )
                checked.append(f"ann verified={res.stats.candidates_verified}")
            if "cp" in caps:
                res = index.cp_search(3)
                assert isinstance(res, CpSearchResult)
                assert res.pairs.shape == (3, 2), res.pairs.shape
                assert res.pairs.dtype == np.int32
                assert res.distances.dtype == np.float32
                assert (res.pairs[:, 0] != res.pairs[:, 1]).all()
                checked.append("cp")
            if "stream" in caps:
                check_stream(index, data, rng)
                checked.append("stream")
            dt = time.perf_counter() - t0
            print(f"  ok   {backend:12s} [{', '.join(checked)}] {dt:.2f}s")
        except Exception as e:  # noqa: BLE001 - report and keep sweeping
            failures.append(backend)
            print(f"  FAIL {backend:12s} {type(e).__name__}: {e}")

    try:
        check_quant(data, queries, rng, device)
    except Exception as e:  # noqa: BLE001
        failures.append("quant-gate")
        print(f"  FAIL quant gate    {type(e).__name__}: {e}")

    try:
        check_cp(data, rng, device)
    except Exception as e:  # noqa: BLE001
        failures.append("cp-gate")
        print(f"  FAIL cp gate       {type(e).__name__}: {e}")

    try:
        check_serve(data, rng, device)
    except Exception as e:  # noqa: BLE001
        failures.append("serve-gate")
        print(f"  FAIL serve gate    {type(e).__name__}: {e}")

    try:
        check_quality(data, rng, device)
    except Exception as e:  # noqa: BLE001
        failures.append("quality-gate")
        print(f"  FAIL quality gate  {type(e).__name__}: {e}")

    try:
        check_sharded(data, queries, rng, device)
    except Exception as e:  # noqa: BLE001
        failures.append("sharded-gate")
        print(f"  FAIL sharded gate  {type(e).__name__}: {e}")

    if failures:
        print(f"check_api: FAILED for {failures}")
        return 1
    print(f"check_api: all {len(available_backends())} backends conform "
          "+ quant gate + cp gate + serve gate + quality gate "
          "+ sharded gate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
