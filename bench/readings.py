"""Read the numbers a cell's check compares over many seeds in one process
on one card: the program's (the lower readings of their limits), with
``--control`` those of the TF32 reference in the program's place (the
upper readings), and with ``--fault <name>`` those of a fault of
``bench/lib/faults.py`` planted in the timed path.

    python3 bench/readings.py --workload deep1m.ann_b64 --seeds 1,2,3 --seconds 3
    python3 bench/readings.py --workload deep1m.ann_b64 --seeds 4,5,6 --seconds 3 --control
    python3 bench/readings.py --workload audio.cp_mixk --seeds 7,8,9 --fault cp_half_rows

Each seed makes its own inputs and index, as a run does, runs a window of
``--seconds`` at the cell's own sizes and load, frees the program's state
and is checked as a run checks it.  One JSON line a seed; for the
closest-pair kind it also looks at the exact pairs an answer left out
(``look``).  Not one of the benchmark's runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def join_d2(x, y):
    """float32 d² of row pairs x, y (P, d) in the pair join's stated
    arithmetic: the cross term by fused multiply-adds over the columns in
    order (each emulated as an exact float64 product and sum rounded to
    float32, double rounding aside), the norms by rounded products and sums
    in column order, then (|x|² + |y|²) − 2 x.y, each step rounded, clamped
    at 0."""
    import torch

    x, y = x.float(), y.float()
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    nx, ny = torch.zeros_like(acc), torch.zeros_like(acc)
    for c in range(x.shape[1]):
        acc = (x[:, c].double() * y[:, c].double() + acc.double()).float()
        nx = nx + x[:, c] * x[:, c]
        ny = ny + y[:, c] * y[:, c]
    return ((nx + ny) - 2.0 * acc).clamp_min(0.0)


def cp_look(kind) -> dict:
    """For each k, the exact nearest pairs the window's answer left out
    (``missed``) against the pairs it gave in their place (``extra``):
    ``gap``, how much farther (float64) the farthest extra pair is than the
    nearest missed one; ``f32_order``, whether in the join's own float32
    arithmetic (``join_d2``) every extra pair ranks at or before every
    missed one, so that the swap is a tie at float32's rounding, with
    ``f32_margin`` the least (missed − extra) of those d²; and ``filtered``,
    the missed pairs whose key gap exceeds the filter's reach at the
    answer's k-th distance, which the join may skip."""
    import numpy as np
    import torch

    ref = kind.reference()
    out = {}
    for k in kind.choices:
        pairs = next(np.asarray(p).reshape(-1, 2) for kk, p, _ in kind.log if kk == k)
        want = kind._nearest[k][0].cpu().numpy()
        code = lambda p: p[:, 0].astype(np.int64) * ref.n + p[:, 1]  # noqa: E731
        missed = want[~np.isin(code(want), code(pairs))]
        extra = pairs[~np.isin(code(pairs), code(want))]
        row = {"missed": int(missed.shape[0])}
        if missed.shape[0] and extra.shape[0]:
            m = missed.shape[0]
            both = torch.from_numpy(np.concatenate([missed, extra]).astype(np.int64))
            both = both.to(ref.rows.device)
            d64 = ref.distances(both).cpu().numpy()
            d2 = join_d2(ref.rows[both[:, 0]], ref.rows[both[:, 1]]).cpu().numpy()
            dk = float(ref.distances(torch.from_numpy(pairs.astype(np.int64))).max())
            gaps = (ref.key[both[:m, 0]] - ref.key[both[:m, 1]]).abs().cpu().numpy()
            row["gap"] = float(d64[m:].max() / d64[:m].min() - 1.0)
            row["f32_order"] = bool(d2[m:].max() <= d2[:m].min())
            row["f32_margin"] = float(d2[:m].min() - d2[m:].max())
            row["filtered"] = int((gaps > ref.reach * dk).sum())
        out[str(k)] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.lib import cells
    from bench.lib.faults import FAULTS
    from bench.lib.harness import Manifest

    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        kind = cells.KINDS[man.traffic(cell)["kind"]](man.config(cell), man.traffic(cell),
                                                     seed, torch.device("cuda"))
        kind.setup()
        if args.fault:
            FAULTS[args.fault](kind)
        if args.control:
            kind.use_control()
        measured = kind.window(args.seconds)
        kind.release()
        torch.cuda.empty_cache()
        checks = kind.check()
        line = {"workload": args.workload, "seed": seed, "control": args.control,
                "fault": args.fault, "checks": {k: v for k, (v, _) in checks.items()},
                "correct": all(v <= lim for v, lim in checks.values()),
                "checked": getattr(kind, "checked", None),
                "found": getattr(kind, "found", None), **measured}
        if isinstance(kind, cells.CpSearch):
            line["look"] = cp_look(kind)
        line["wall_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del kind
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
