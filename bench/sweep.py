"""Offer a serving cell's traffic at several fixed rates, in one process on
one card, to find the highest rate the system sustains.

    python3 bench/sweep.py --workload deep1m.serve_open --seed 7 --seconds 4 \
        --rates 4000,8000,12000,16000

For each rate it prints one JSON line: the requests due, the rate answered,
p50 and p95 from when each was due, the share not answered ok, and how late
the generator ran.  A rate is sustained while the answered rate keeps up
with it and p95 stays flat; the cell's ``rate_qps`` is set near 4/5 of the
highest such rate.  Not one of the benchmark's runs: it checks nothing.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.lib import cells
    from bench.lib.harness import Manifest

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 3
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    traffic = man.traffic(cell)
    kind = cells.KINDS[traffic["kind"]](man.config(cell), traffic, args.seed,
                                        torch.device("cuda"))
    kind.setup()
    for rate in [float(r) for r in args.rates.split(",")]:
        kind.set_rate(rate)
        t = time.perf_counter()
        got = kind.window(args.seconds)
        print(json.dumps({"rate": rate, **got, "lost": kind.failed / max(kind.attempted, 1),
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
