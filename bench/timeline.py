"""What the program's spans cost on the profiler's clock, and where the
device's idle time falls among them, for one cell on one card.

    python3 bench/timeline.py --workload deep1m.ann_b64 --seed 7 --seconds 3

It sets the cell up as a run does and runs a window of ``--seconds``, then
takes the cell's profiled slice (``kind.profile_slice()``, as a traced run
does) in turns with the program's profiler ranges paused
(``repro_torch.obs.trace.paused()``) and open: plain, ranged, ranged,
plain, ``--rounds`` times.  Each slice gives its ms a call, idle share and
program ranges a call; each ranged slice also the device-idle ms a call
split by the innermost program span open, summed by layer, and its ten
longest gaps, each as [span open at its middle, ms, span open at its
start, span open at its end, the label a traced run's ``breakdown`` gives
it].  One JSON line on standard output; ``--out <file>`` also writes the
slices' breakdowns.  Not one of the benchmark's runs: it checks nothing.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the layer of a span, by its name's first word ("": no span open)
LAYERS = {"index": "facade", "ann": "pipeline", "cp": "pipeline", "quant": "pipeline",
          "kernel": "pipeline", "sync": "sync", "serve": "serve"}


def _innermost(ranges, t: float) -> str:
    best = None
    for e in ranges:
        if e.t0 <= t <= e.t1 and (best is None or e.t0 >= best.t0):
            best = e
    return best.name if best is not None else "(no span)"


def _reading(prof, names: set, ranged: bool) -> dict:
    from bench.lib import spans

    calls = max(prof.calls, 1)
    ranges = [e for e in prof.host if e.name in names]
    out = {"ranged": ranged, "calls": prof.calls, "ms_a_call": prof.window_s * 1e3 / calls,
           "idle_share": 100.0 * (1.0 - prof.busy_s / prof.window_s),
           "ranges_a_call": len(ranges) / calls}
    if ranged:
        by_layer: dict = {}
        for span, us in spans.idle_by_span(prof, names).items():
            layer = LAYERS.get(span.split(".")[0], "outside")
            by_layer[layer] = by_layer.get(layer, 0.0) + us / 1e3 / calls
        out["idle_ms_a_call_by_layer"] = by_layer
        gaps = sorted(prof.gaps(), key=lambda g: g[0] - g[1])[:10]
        out["idle_gaps"] = [[_innermost(ranges, (a + b) / 2), (b - a) / 1e3,
                             _innermost(ranges, a), _innermost(ranges, b),
                             prof.host_label((a + b) / 2)] for a, b in gaps]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.lib import cells
    from bench.lib.harness import Manifest
    from repro_torch.obs import trace

    if not torch.cuda.is_available():
        print("timeline: CUDA is not available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    traffic = man.traffic(cell)
    kind = cells.KINDS[traffic["kind"]](man.config(cell), traffic, args.seed,
                                        torch.device("cuda"))
    kind.setup()
    line = {"workload": args.workload, "seed": args.seed,
            "card": torch.cuda.get_device_name(0), "window": kind.window(args.seconds)}
    names = {s.name for s in kind.span_slice().spans}
    readings, full = [], []
    for r in range(args.rounds):  # plain, ranged, ranged, plain, ...
        for ranged in (False, True) if r % 2 == 0 else (True, False):
            if ranged:
                prof = kind.profile_slice()
            else:
                with trace.paused():
                    prof = kind.profile_slice()
            readings.append(_reading(prof, names, ranged))
            full.append({"ranged": ranged, **prof.breakdown(top=40)})
    line["slices"] = readings
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({**line, "breakdowns": full}))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
