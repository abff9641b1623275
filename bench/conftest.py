"""Test support for the benchmark's own tests (``bench/test_bench_*.py``):
the ``cuda`` marker, and tiny versions of the cells that run on the CPU."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

#: each cell cut to a size the CPU runs in a second or two
TINY = {
    "deep1m": {"n": 9000, "d": 32},
    "audio": {"n": 2000, "d": 24},
    "batch_search": {"batch": 8, "pool": 512, "trace_calls": 4, "check_calls": 4},
    "cp_search": {"trace_calls": 6},
    "serve_open": {"rate_qps": 400, "pool": 2048, "check_requests": 64,
                   "trace_seconds": 0.2},
}
#: the kinds' knobs at the CPU's pace: calls a window makes at least (enough
#: for k to change in the closest-pair mix), the wait for late answers
PACE = {"batch_search": {"min_calls": 6}, "cp_search": {"min_calls": 8},
        "serve_open": {"grace_s": 1.0}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the repro_torch CUDA kernels); "
        "SKIPS visibly where torch.cuda.is_available() is false")


@pytest.fixture()
def tiny_run(monkeypatch):
    """``tiny_run(cell, trace=False, tamper=None, control=False)``: one run of
    the cell at its TINY size on the CPU, through the harness's whole path
    but its look for a card.  The test process may hold JAX from other
    tests, so the harness's module check is left to its own tests."""
    import torch

    from bench.lib import harness

    monkeypatch.setattr(harness, "forbidden_modules", lambda modules=None: [])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # steady beside the other test workers

    def run(cell, *, trace=False, tamper=None, control=False, seconds=0.3,
            seed=2 ** 31 + 7):
        man = harness.Manifest(ROOT)
        w = man.workload(cell)
        config, traffic = man.config(w), man.traffic(w)
        config["dataset"].update(TINY[config["name"]])
        traffic.update(TINY[traffic["kind"]])

        def paced(kind):
            for name, value in PACE[traffic["kind"]].items():
                setattr(kind, name, value)
            if tamper is not None:
                tamper(kind)

        return harness.run_cell(cell, seed, seconds, trace, started=time.perf_counter(),
                                device="cpu", manifest=man, config=config,
                                traffic=traffic, tamper=paced, control=control)

    yield run
    torch.set_num_threads(threads)
