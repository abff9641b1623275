#!/usr/bin/env python3
"""Closest-pair search of the PyTorch port on the Audio twin, on one NVIDIA
GPU: ``cp_search(10)`` wall time and idle share, and the pair_join
kernel's times, launches and host syncs.

    python3 scripts/torch_cp.py [TREE] [--seed 0] [--dump FILE] [--against FILE]

TREE is the root of a checkout of this repository whose ``src/repro_torch``
is measured (default: this one), so that two commits can be compared in
one run on one card: unpack the other into a git-ignored directory and run
this script on each in turns.  The Audio twin (n = 54,387, d = 192, 40
clusters, 6 active dimensions) and the ``flat`` index are ``chip_smoke.py``'s,
made from ``--seed``.  It prints one JSON line: the median ``cp_search``
wall time by CUDA events (7 calls after a warm-up), the device busy time
and idle share of one traced call, its host syncs, and for the join on the index's sorted
rows its time by CUDA events, its device time (torch.profiler, median of
5 traces), its CUDA kernels and copies in one call, and the host syncs one
call makes (``torch.cuda.set_sync_debug_mode("warn")``).  ``--dump``
writes the join's answer and counters to an .npz, on the Audio twin and
on CASES (seeded rows: duplicates, d not a multiple of 4, k = 128,
several groups of bands); ``--against`` reads one and reports whether
this tree's are identical to it, bit for bit, case by case.  Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (n, d, k, thresh2, duplicated rows); rows made from the seed
CASES = {"duplicates": (5000, 16, 20, 16.0, True), "d_33": (3000, 33, 10, 16.0, False),
         "k_128": (4000, 32, 128, 16.0, False), "groups": (20000, 64, 10, 16.0, False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_cp: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first: the tree's goes before it

    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    from repro_torch.core.cp_fused import cp_threshold2
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import pair_join as kjoin

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.join(tree, "src")):
        raise SystemExit(f"torch_cp: imported {repro_torch.__file__}, not {tree}'s")

    dev = torch.device("cuda")
    audio = cs.make_clustered_twin(cs.AUDIO_N, cs.AUDIO_D, args.seed + 4, clusters=40, active=6)
    cfg = IndexConfig(backend="flat", seed=args.seed)
    index = build_index(audio, cfg, device=dev)

    def search():
        return index.cp_search(cs.K)

    wall = cs.time_ms(torch, search, reps=7, warmup=1)
    prof = cs.profile_call(torch, search, wall, rows=4)

    key = index.impl.projected[:, 0]
    order = torch.sort(key, stable=True).indices
    xs, ks = index.impl.data[order].contiguous(), key[order].contiguous()
    thresh2 = cp_threshold2(cfg.cp_c, cfg.m, 1.0)

    def join():
        return kjoin.pair_join(xs, ks, cs.K, thresh2=thresh2)

    joins = {"audio": [t.cpu().numpy() for t in join()]}
    for name, (n, d, k, t2, dup) in CASES.items():
        rng = np.random.default_rng(args.seed + n + d)
        x = rng.normal(size=(n, d)).astype(np.float32)
        if dup:
            x[1::3] = x[0::3][:x[1::3].shape[0]]
        kx = (x @ rng.normal(size=(d,))).astype(np.float32)
        o = np.argsort(kx, kind="stable")
        xc, kc = torch.from_numpy(x[o]).to(dev), torch.from_numpy(kx[o]).to(dev)
        joins[name] = [t.cpu().numpy() for t in kjoin.pair_join(xc, kc, k, thresh2=t2)]
    out = joins["audio"]
    traced = cs.traced_calls(torch, join)
    kernels = [name for name, _ in traced[-1] if "emcpy" not in name and "emset" not in name]
    line = {"tree": tree, "cp_search_wall_ms": wall, "busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "by_kernel": prof["by_kernel"],
            "cp_search_host_syncs": cs.host_syncs(torch, search),
            "join_ms": cs.time_ms(torch, join),
            "join_device_ms": cs.device_ms(torch, join),
            "join_cuda_kernels": len(kernels), "join_device_events": len(traced[-1]),
            "join_host_syncs": cs.host_syncs(torch, join),
            "join_stats": out[3].tolist()}
    parts = ("v", "i", "j", "stats")
    if args.dump:
        np.savez(args.dump, **{f"{case}_{p}": a for case, got in joins.items()
                               for p, a in zip(parts, got)})
    if args.against:
        ref = np.load(args.against)
        line["identical_to"] = args.against
        line["identical"] = {case: all(np.array_equal(a.view(np.uint8),
                                                      ref[f"{case}_{p}"].view(np.uint8))
                                       for p, a in zip(parts, got))
                             for case, got in joins.items()}
    line["card"] = cs.nvidia_smi()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
