"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs from the seed on
the card, builds and warms the program's index (set-up, ``setup_s``),
drives the cell's entry for ``--seconds`` (the window), and with
``--trace 1`` then profiles one slice of the same traffic and records the
program's spans over another.  Once the program's state is freed it holds
what the window produced against the plain reference in ``bench/
reference``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``breakdown`` (traced runs) and last ``checks``, each number compared
beside its limit, which also close standard error.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and if JAX or the JAX package was loaded.  The
program's CUDA build stays in ``build/repro_torch/<digest>`` inside the
checkout; other caches go under ``build/bench_cache``.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def since_process_start() -> float:
    """Seconds from the process's start to now (Linux; 0 where unknown)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start / ticks, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    started = STARTED - max(since_process_start() - (time.perf_counter() - STARTED), 0.0)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))

    import torch

    from bench.lib.harness import Manifest, run_cell

    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; the benchmark runs on an NVIDIA GPU",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             started=started, device="cuda", manifest=manifest)
    print("bench: " + json.dumps(notes), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
