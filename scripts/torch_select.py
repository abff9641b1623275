#!/usr/bin/env python3
"""The PyTorch port's radius select on one NVIDIA GPU, at the shape of the
benchmark's ``deep1m.ann_b64`` cell: its time, and its answers and the
flat search's held bit for bit to another tree's.

    python3 scripts/torch_select.py [TREE] [--seed 1] [--calls 32] [--dump FILE] [--against FILE]

TREE is the root of a checkout of this repository whose ``src/repro_torch``
is measured (default: this one), so that two commits can be compared in
one run on one card: unpack the other into a git-ignored directory and run
this script on each in turns.  The data are the cell's, made from
``--seed`` by this checkout's ``bench/``: the Deep1M twin (1,000,000 × 256),
the flat index over it with the configuration's A, and the pool of
queries in the seed's order.  ``--calls`` batches of 64 are searched
through ``FlatBackend.search``; then, on the first batch's projected
estimates (64, 1M) at the search's own budget T, one JSON line a route of
``ops.radius_select``: the ordered one (ascending, as the reference's
kernel and trim give it), and where the tree has it the unordered one the
fused search takes.  Each line gives the time by CUDA events (median of
10 after a warm-up), the device time (torch.profiler, median of 5 traces)
with the call's kernels and copies by name, its host syncs (PyTorch's
sync debug mode) and the bound (the estimates read once and T (value,
id) pairs written once a row at 3.35 TB/s); the plain version's and
``torch.topk(d, T, largest=False)``'s event times go on the last line;
where the tree's kernel reports them, the rows' final band, bracket
entries and fallbacks on a line before it.  ``--dump`` writes every
search's ids, distances and survivor counts and the ordered select's
values, ids and counts to an .npz; ``--against`` reads one and reports
whether this tree's are identical to it.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--calls", type=int, default=32)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_select: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first: the tree's goes before it
    from bench.lib.cells import BatchSearch

    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    from repro_torch.core.fused import select_seed
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import select as ksel

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.join(tree, "src")):
        raise SystemExit(f"torch_select: imported {repro_torch.__file__}, not {tree}'s")

    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "bench", "configs", "deep1m.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "bench", "traffic", "ann_batch.json")) as f:
        traffic = json.load(f)
    cell = BatchSearch(config, traffic, args.seed, dev)
    cell.setup()
    index, impl = cell.index, cell.index.impl
    found = {"ids": [], "dist": [], "counts": []}
    for i in range(args.calls):
        res = index.search(cell.batch(i), k=cell.k)
        found["ids"].append(res.indices)
        found["dist"].append(res.distances)
        found["counts"].append(index.last_select_counts.copy())
    T = index.last_select_budget
    q = torch.from_numpy(cell.batch(0)).to(dev)
    d2p = ops.pairwise_sq_dist(impl.family.project(q), impl.projected)
    tau0 = select_seed(d2p, T, impl.m)
    B, n = d2p.shape
    t_bound, by = cs.bound(4 * B * n + 8 * B * T, B * n)
    routes = {"ordered": lambda: ops.radius_select(d2p, T, tau0=tau0, with_count=True)}
    if "ordered" in inspect.signature(ops.radius_select).parameters:
        routes["unordered"] = lambda: ops.radius_select(d2p, T, tau0=tau0, with_count=True,
                                                        ordered=False)
    sel = routes["ordered"]()
    found.update(sel_vals=sel[0].cpu().numpy(), sel_ids=sel[1].cpu().numpy(),
                 sel_counts=sel[2].cpu().numpy())
    card = torch.cuda.get_device_name(0)
    for name, fn in routes.items():
        traced = cs.traced_calls(torch, fn)
        run = max(traced, key=len)
        cs.emit({"tree": tree, "card": card, "route": name, "shape": [B, n], "T": T,
                 "ms": cs.time_ms(torch, fn),
                 "device_ms": float(np.median([sum(ms for _, ms in r) for r in traced])),
                 "device_ops": [[k, round(ms, 4)] for k, ms in run],
                 "host_syncs": cs.host_syncs(torch, fn), "bound_ms": t_bound, "bound_by": by})
    if "stats" in inspect.signature(ksel.radius_select).parameters:
        stats = ksel.radius_select(d2p, tau0, T, stats=True)[3].cpu().numpy()
        cs.emit({"tree": tree, "band": [int(v) for v in np.percentile(stats[:, 0], [0, 50, 100])],
                 "buffered": [int(v) for v in np.percentile(stats[:, 1], [0, 50, 100])],
                 "fallback_rows": int(stats[:, 2].sum())})
    plain = getattr(ref, "radius_select_exact", None)
    cs.emit({"tree": tree, "card": card,
             "plain_ms": None if plain is None else cs.time_ms(
                 torch, lambda: plain(d2p, tau0, T), reps=3, warmup=1),
             "library_ms": cs.time_ms(torch, lambda: torch.topk(d2p, T, largest=False),
                                      reps=3, warmup=1),
             "search_ms": cs.time_ms(torch, lambda: index.search(cell.batch(0), k=cell.k),
                                     reps=10, warmup=2)})
    arrays = {k: np.stack(v) if isinstance(v, list) else v for k, v in found.items()}
    if args.dump:
        np.savez(args.dump, **arrays)
    if args.against:
        other = np.load(args.against)
        same = {k: bool(np.array_equal(arrays[k], other[k])) for k in arrays}
        cs.emit({"tree": tree, "against": args.against, "identical": same})
        return 0 if all(same.values()) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
