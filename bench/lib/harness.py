"""One run of one cell: find its files by name, set up, measure, trace,
check, and assemble the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel cost model is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  bench/configs/<config>.json    sizes and index parameters
  bench/traffic/<traffic>.json   the mix: a ``kind`` of ``bench.lib.cells``
                                 and its parameters, and the limits of the
                                 numbers its check compares
  bench/metrics/<metric>.py      ``read(run) -> float | None``
  bench/cost/<kernel>.py         ``KERNELS`` (patterns of the kernels'
                                 names) and ``cost(**shape)`` -> (bytes,
                                 FLOPs)
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench.lib import cells
from bench.lib.profiling import Profile, SpanSlice, csrc_kernel_names

__all__ = ["BENCH", "ROOT", "Manifest", "RunRecord", "run_cell", "forbidden_modules",
           "load_module", "PEAKS"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
#: top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s outside the
#: tensor cores (where the program's kernels compute), at 700 W
PEAKS = {"bytes_per_s": 3.35e12, "flops_per_s": 6.7e13}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (of ``sys.modules`` by default) whose top-level name,
    the part before the first dot compared whole, is JAX's or the JAX
    package's: ``repro.index`` is one, ``repro_torch.index`` is not."""
    names = list(sys.modules if modules is None else modules)
    return sorted(name for name in names if name.split(".", 1)[0] in FORBIDDEN)


def load_module(path: Path):
    """Import a file by path (names may hold dots, which ``import`` cannot)."""
    name = "bench_file_" + "".join(ch if ch.isalnum() else "_" for ch in
                                   str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        return self.workloads[name]

    def config(self, workload: dict) -> dict:
        return json.loads((self.root / self.configs[workload["config"]]["file"]).read_text())

    def traffic(self, workload: dict) -> dict:
        return json.loads((BENCH / "traffic" / f"{workload['traffic']}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


@dataclasses.dataclass
class RunRecord:
    """What a per-layer metric's reader is handed."""

    cell: str
    config: dict
    traffic: dict
    kind: object
    profile: Profile | None
    spans: SpanSlice | None
    csrc_kernels: set
    peaks: dict

    def cost(self, kernel: str):
        return load_module(BENCH / "cost" / f"{kernel}.py")


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             started: float, device: str | torch.device = "cuda",
             manifest: Manifest | None = None, config: dict | None = None,
             traffic: dict | None = None, tamper=None, control: bool = False):
    """Run one cell once.  Returns the result line (a dict) and notes for
    standard error (the window's other readings, set-up, what was checked).

    ``started`` is the ``time.perf_counter()`` reading taken as the process
    began.  ``config`` / ``traffic`` replace the cell's files (the tests run
    small sizes on the CPU with them); ``tamper(kind)`` breaks the timed path
    after set-up (the tests' planted faults); ``control`` puts the TF32
    reference in the program's place.
    """
    man = manifest or Manifest()
    cell = man.workload(workload)
    config = config or man.config(cell)
    traffic = traffic or man.traffic(cell)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = None
    if device.type == "cuda":
        # the program's kernel library: nvcc builds it on a checkout's first
        # run, later runs load it from build/repro_torch; timed apart here,
        # and part of setup_s all the same
        from repro_torch.kernels import _build

        t = time.perf_counter()
        _build.load()
        build_s = time.perf_counter() - t
    kind = cells.KINDS[traffic["kind"]](config, traffic, seed, device)
    kind.setup()
    if tamper is not None:
        tamper(kind)
    if control:
        kind.use_control()
    setup_s = time.perf_counter() - started
    measured = kind.window(seconds)
    profile = spans = None
    if trace:
        spans = kind.span_slice()
        profile = kind.profile_slice()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"bench: forbidden modules loaded: {found}")
    kind.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check()
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **measured}
        for m in man.end_to_end(workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    else:
        record = RunRecord(workload, config, traffic, kind, profile, spans,
                           csrc_kernel_names(CSRC), PEAKS)
        for m in man.per_layer(workload):
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    if profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": int(kind.attempted), "failed": int(kind.failed),
              "metrics": metrics, "device": dev}
    if profile is not None:
        result["breakdown"] = profile.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    notes = {k: v for k, v in measured.items() if k not in metrics}
    notes.update(setup_s=setup_s, build_s=build_s, checked=getattr(kind, "checked", None),
                 entry=kind.entry)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"bench: forbidden modules loaded: {found}")
    return result, notes
