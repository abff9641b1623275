#!/usr/bin/env python3
"""The PyTorch port's pairwise_sq_dist and project_dist kernels on one
NVIDIA GPU: their times at the shapes the paths give them, and their
outputs held bit for bit to another tree's.

    python3 scripts/torch_dist.py [TREE] [--seed 0] [--dump FILE] [--against FILE]

TREE is the root of a checkout of this repository whose ``src/repro_torch``
is measured (default: this one), so that two commits can be compared in
one run on one card: unpack the other into a git-ignored directory and run
this script on each in turns.  The data are ``chip_smoke.py``'s, made from
``--seed``: the Deep1M twin (n = 1,000,000, d = 256), the flat index's
projected rows (m = 15) and 64 queries.  SHAPES are timed: pairwise at the
float path's estimate (B = 1, 16, 64 against the projected rows) and at the
stream's delta scan (64 queries against 32,768 and 16,374 rows of the same
mixture, d = 256); project_dist at (64, 1M, 256, 15) with
``chip_smoke.py``'s own A.  Each gets one JSON line: its time by CUDA
events (median of 10 after a warm-up), its device time (torch.profiler,
median of 5 traces), the CUDA kernels of one call by name, its bound on
the card (each input read once and the output written once at 3.35 TB/s,
or its flops at 67 TFLOP/s, the larger) and ``torch.cdist(...) ** 2``'s
event time on the same inputs.  ``--dump`` writes every shape's output
and CASES' (seeded: N % 4 != 0, N < 4, x one row or one float past an
aligned start, B = 130, d = 1 to 4096, m = 1 to 32) to an .npz;
``--against`` reads one and reports, case by case, whether this tree's
outputs are identical to it bit for bit, and where not, how many entries
differ and by how much.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (kernel, B, N, d, m, x offset in floats); rows made from the seed.
# pairwise cases have m = 0; an offset of d starts x one row in, 1 one float in
CASES = {
    "pw_n_mod4": ("pairwise", 5, 1001, 15, 0, 0),
    "pw_n3": ("pairwise", 3, 3, 15, 0, 0),
    "pw_n1": ("pairwise", 2, 1, 15, 0, 0),
    "pw_x_row_offset": ("pairwise", 7, 999, 15, 0, 15),
    "pw_b130": ("pairwise", 130, 5000, 15, 0, 0),
    "pw_d1": ("pairwise", 9, 2000, 1, 0, 0),
    "pw_d16": ("pairwise", 9, 2000, 16, 0, 0),
    "pw_d17": ("pairwise", 9, 2000, 17, 0, 0),
    "pw_d32": ("pairwise", 9, 2000, 32, 0, 0),
    "pw_d33": ("pairwise", 9, 2000, 33, 0, 0),
    "pw_d33_row_offset": ("pairwise", 7, 999, 33, 0, 33),
    "pw_d600": ("pairwise", 9, 2000, 600, 0, 0),
    "pw_d4096": ("pairwise", 5, 700, 4096, 0, 0),
    "pw_b130_d256": ("pairwise", 130, 3001, 256, 0, 0),
    "pj_n_mod4": ("project", 5, 1001, 64, 15, 0),
    "pj_m1": ("project", 3, 500, 64, 1, 0),
    "pj_m16": ("project", 7, 777, 33, 16, 0),
    "pj_m17": ("project", 7, 777, 96, 17, 0),
    "pj_m32": ("project", 9, 2000, 256, 32, 0),
    "pj_d600": ("project", 5, 3000, 600, 15, 0),
    "pj_d4096": ("project", 1, 4099, 4096, 15, 0),
    "pj_x_float_offset": ("project", 5, 999, 256, 15, 1),
    "pj_b130": ("project", 130, 3000, 96, 20, 0),
}
DELTA_ROWS = (32_768, 16_374)  # delta_threshold, and the delta after round 24


def case_inputs(torch, dev, seed: int, kernel: str, B: int, N: int, d: int, m: int,
                offset: int):
    """Seeded numpy inputs of a case on the card: (q, x) or (x, a, qp)."""
    import numpy as np

    rng = np.random.default_rng(seed + 7 * B + 31 * N + d + 1009 * m + offset)
    flat = rng.normal(size=(N * d + offset,)).astype(np.float32)
    x = torch.from_numpy(flat).to(dev)[offset:].view(N, d)
    if kernel == "pairwise":
        return torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev), x
    a = torch.from_numpy(rng.normal(size=(d, m)).astype(np.float32)).to(dev)
    qp = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev) @ a
    return x, a, qp


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
        print("torch_dist: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src first: the tree's goes before it

    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    from repro_torch.index import IndexConfig, build_index
    from repro_torch.kernels import pairwise_dist as kpair
    from repro_torch.kernels import project_dist as kproj

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.join(tree, "src")):
        raise SystemExit(f"torch_dist: imported {repro_torch.__file__}, not {tree}'s")

    dev = torch.device("cuda")
    data = cs.make_clustered_twin(cs.N_POINTS, cs.DIM, args.seed)
    queries = cs.make_queries(data, max(cs.BATCHES), args.seed + 1)
    impl = build_index(data, IndexConfig(backend="flat", seed=args.seed), device=dev).impl
    q64 = torch.from_numpy(queries).to(dev)
    qp64 = impl.family.project(q64)
    fresh = cs.make_clustered_twin(max(DELTA_ROWS), cs.DIM, args.seed, rows_seed=args.seed + 5)
    g = torch.Generator(device=dev).manual_seed(args.seed + 6)  # project_phase's A
    a = torch.randn((impl.d, impl.m), generator=g, device=dev)

    # name: (fn, library call, bytes, flops) at the paths' shapes
    shapes = {}
    for B in cs.BATCHES:
        qp, x = qp64[:B].contiguous(), impl.projected
        shapes[f"estimate_b{B}"] = (
            lambda qp=qp, x=x: kpair.pairwise_sq_dist(qp, x),
            lambda qp=qp, x=x: torch.cdist(qp, x) ** 2,
            4 * (B * impl.m + impl.n * impl.m + B * impl.n), 2 * B * impl.n * (impl.m + 1))
    for rows in DELTA_ROWS:
        x = torch.from_numpy(fresh[:rows]).to(dev)
        shapes[f"delta_{rows}"] = (
            lambda x=x: kpair.pairwise_sq_dist(q64, x),
            lambda x=x: torch.cdist(q64, x) ** 2,
            4 * (64 * impl.d + rows * impl.d + 64 * rows), 2 * 64 * rows * (impl.d + 1))
    qpa = q64 @ a
    shapes["project"] = (
        lambda: kproj.project_dist(impl.data, a, qpa),
        lambda: torch.cdist(qpa, impl.data @ a) ** 2,
        4 * (impl.n * impl.d + impl.d * impl.m + 64 * impl.m + 64 * impl.n),
        2 * impl.n * impl.d * impl.m + 2 * 64 * impl.n * impl.m)

    outputs = {}
    for name, (fn, library, nbytes, flops) in shapes.items():
        outputs[name] = fn().cpu().numpy()
        traced = cs.traced_calls(torch, fn)
        t_bound, by = cs.bound(nbytes, flops)
        cs.emit({"tree": tree, "shape": name, "ms": cs.time_ms(torch, fn),
                 "device_ms": statistics.median(sum(ms for _, ms in run) for run in traced),
                 "bound_ms": t_bound, "bound_by": by,
                 "library_ms": cs.time_ms(torch, library, reps=5, warmup=1),
                 "kernels": sorted({n for n, _ in traced[-1]})})
    del shapes
    for name, (kernel, B, N, d, m, offset) in CASES.items():
        ins = case_inputs(torch, dev, args.seed, kernel, B, N, d, m, offset)
        fn = kpair.pairwise_sq_dist if kernel == "pairwise" else kproj.project_dist
        outputs[name] = fn(*ins).cpu().numpy()

    line = {"tree": tree, "cases": len(outputs)}
    if args.dump:
        np.savez(args.dump, **outputs)
    if args.against:
        ref = np.load(args.against)
        line["identical_to"] = args.against
        line["identical"], line["differ"] = {}, {}
        for name, got in outputs.items():
            want = ref[name]
            same = got.shape == want.shape and np.array_equal(got.view(np.uint32),
                                                              want.view(np.uint32))
            line["identical"][name] = same
            if not same and got.shape == want.shape:
                diff = np.abs(got.astype(np.float64) - want)
                line["differ"][name] = {"entries": int((got.view(np.uint32)
                                                        != want.view(np.uint32)).sum()),
                                        "max_abs": float(diff.max())}
        line["all_identical"] = all(line["identical"].values())
    line["card"] = cs.nvidia_smi()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
