#!/usr/bin/env python3
"""Device busy time of the PyTorch port's searches, per batch size, on one
NVIDIA GPU: the float, flat-pq and stream paths of ``chip_smoke.py``.

    python3 scripts/torch_busy.py [TREE] [--seed 0]

TREE is the root of a checkout of this repository whose ``src/repro_torch``
is measured (default: this one), so that two commits can be compared in
one run on one card: unpack the other into a git-ignored directory and
run this script on each in turns.  The data, queries and stream churn are
``chip_smoke.py``'s (the Deep1M twin, 24 rounds of inserts and deletes, a
flush after round 20), made from ``--seed``.  For each path and B in
{1, 16, 64} it prints, as one JSON line: the median wall time of a search
by CUDA events, the device busy time of one traced search, the share of
it that verify_topk's launches take (its topk launches included), the
idle share, and the host-side CUDA calls of that search (launches,
memsets, copies, syncs, allocations).  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync",
              "cudaStreamSynchronize", "cudaMalloc", "cudaFree", "cudaFuncSetAttribute")


def host_calls(torch, fn) -> dict:
    """Counts of the CUDA runtime calls one ``fn()`` makes on the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    got = {e.key: e.count for e in prof.key_averages() if e.key in HOST_CALLS}
    return {name: got.get(name, 0) for name in HOST_CALLS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_busy: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first: the tree's goes before it

    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.index import IndexConfig, build_index

    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(os.path.join(tree, "src")):
        raise SystemExit(f"torch_busy: imported {repro_torch.__file__}, not {tree}'s")

    dev = torch.device("cuda")
    data = cs.make_clustered_twin(cs.N_POINTS, cs.DIM, args.seed)
    queries = cs.make_queries(data, max(cs.BATCHES), args.seed + 1)

    def report(path, index):
        for B in cs.BATCHES:
            def search():
                return index.search(queries[:B], cs.K)
            wall = cs.time_ms(torch, search, reps=7, warmup=1)
            prof = cs.profile_call(torch, search, wall, rows=0)
            print(json.dumps({"tree": tree, "path": path, "B": B, "wall_ms": wall,
                              "busy_ms": prof["device_busy_ms"],
                              "verify_topk_ms": prof["verify_topk_ms"],
                              "idle_share": prof["idle_share"],
                              "host_calls": host_calls(torch, search)}), flush=True)

    report("float", build_index(data, IndexConfig(backend="flat", seed=args.seed), device=dev))
    report("flat-pq", build_index(data, IndexConfig(backend="flat-pq", seed=args.seed),
                                  device=dev))
    cfg = IndexConfig(backend="streaming", seed=args.seed, options={
        "segment_backend": "flat", "delta_threshold": cs.STREAM_THRESHOLD, "max_segments": 4})
    index = build_index(data, cfg, device=dev)
    fresh = cs.make_clustered_twin(cs.STREAM_ROUNDS * cs.STREAM_BATCH, cs.DIM, args.seed,
                                   rows_seed=args.seed + 5)
    rng = np.random.default_rng(args.seed + 6)
    for r in range(cs.STREAM_ROUNDS):
        index.insert(fresh[r * cs.STREAM_BATCH:(r + 1) * cs.STREAM_BATCH])
        index.delete(cs.churn_deletes(rng, index, r, cs.N_POINTS))
        if r + 1 in cs.STREAM_FLUSH_AFTER:
            index.flush()
    report(f"stream (segments {[s.size for s in index.segments]}, delta {index.delta_size})",
           index)
    return 0


if __name__ == "__main__":
    sys.exit(main())
