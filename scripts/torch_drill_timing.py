"""What the serve drill's p99 gate reads on this host: how long a
requested sleep lasts, how long a search takes right after one, and the
drill's fault-free and chaos p99 with its sleeps taken by ``time.sleep``
(``old``) or by ``chaos.precise_sleep`` (``new``), in turns.

    PYTHONPATH=src python scripts/torch_drill_timing.py [--device cuda] [--reps 2]

Prints one JSON line a measurement.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.index import IndexConfig, build_index
from repro_torch.resilience import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEPS = {"old": time.sleep, "new": chaos.precise_sleep}


def _ms(values) -> dict:
    v = np.asarray(values) * 1e3
    return {"median": float(np.median(v)), "p90": float(np.percentile(v, 90)),
            "max": float(v.max())}


def _timed(fn, n: int, before=None) -> list:
    out = []
    for _ in range(n):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of old, new, new, old over seeds 0-4")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()
        _build.load()

    for seconds in (0.000128, 0.0016):
        for name, sleep in SLEEPS.items():
            print(json.dumps({"sleep_ms": seconds * 1e3, "by": name,
                              "actual_ms": _ms(_timed(lambda: sleep(seconds), 50))}),
                  flush=True)

    # the drill's primary tier: flat over 1,024 × 16 keys, B = 8, k = 8
    keys = np.random.default_rng(0).standard_normal((1024, 16)).astype(np.float32)
    index = build_index(keys, IndexConfig(backend="flat", seed=0), device=device)
    q = keys[:8] + 0.1
    search = lambda: index.search(q, k=8)  # noqa: E731
    _timed(search, 10)
    for pause, by in ((None, None), (0.0016, "old"), (0.0016, "new"), (None, None)):
        before = None if pause is None else (lambda s=SLEEPS[by]: s(pause))
        print(json.dumps({"search_after_pause_ms": 0.0 if pause is None else pause * 1e3,
                          "pause_by": by, "search_ms": _ms(_timed(search, 30, before))}),
              flush=True)

    spec = importlib.util.spec_from_file_location(
        "torch_chaos_drill", os.path.join(ROOT, "scripts", "torch_chaos_drill.py"))
    drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drill)
    ratios, failed = {"old": [], "new": []}, {"old": 0, "new": 0}
    for rep in range(args.reps):
        for by in ("old", "new", "new", "old"):
            # FaultPlan and RequestScheduler read chaos.precise_sleep when built
            chaos.precise_sleep = SLEEPS[by]
            try:
                for seed in range(5):
                    try:
                        s = drill.serve_drill(seed, device)
                        ok = True
                    except AssertionError as e:
                        s, ok = {"error": str(e)}, False
                    if ok:
                        ratios[by].append(s["p99_chaos_ms"] / s["p99_base_ms"])
                    else:
                        failed[by] += 1
                    print(json.dumps({"rep": rep, "sleep_by": by, "seed": seed,
                                      "passed": ok, **s}), flush=True)
            finally:
                chaos.precise_sleep = SLEEPS["new"]
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    print(json.dumps({"chaos_over_fault_free": {
        by: {"passed": len(r), "failed": failed[by],
             "median": statistics.median(r) if r else None,
             "max": max(r) if r else None} for by, r in ratios.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
