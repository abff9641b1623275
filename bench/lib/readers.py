"""What the per-layer metrics' readers (``bench/metrics/<metric>.py``)
share.  Each returns None where its run holds nothing to read: no
profile, no spans, no call of the entry, no device time of the kernels."""
from __future__ import annotations

import re

import torch

__all__ = ["idle_share", "aten_ms", "kernels_per", "span_self_ms", "host_share",
           "entry_self_ms", "roofline"]


def idle_share(run) -> float | None:
    """% of the profiled window in which the device ran nothing."""
    p = run.profile
    if p is None or p.window_s <= 0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def aten_ms(run) -> float | None:
    """Device ms a call spent outside the program's own CUDA kernels:
    torch's kernels (gathers, sorts, copies), memcpys and memsets."""
    p = run.profile
    if p is None or p.calls <= 0 or not p.device:
        return None
    rx = re.compile(r"\b(" + "|".join(sorted(run.csrc_kernels)) + r")\b")
    other = sum(e.t1 - e.t0 for e in p.device
                if not (e.cat == "kernel" and rx.search(e.name)))
    return other / 1e3 / p.calls


def kernels_per(run, per_call: int) -> float | None:
    """Device kernels in the profiled slice for each of ``per_call`` units
    a call serves (1: a call; B: a query of a batch)."""
    p = run.profile
    if p is None or p.calls <= 0 or not p.device:
        return None
    return len(p.kernels()) / (p.calls * per_call)


def span_self_ms(run, name: str, child_prefix: str) -> float | None:
    """Mean ms of a ``name`` span less its ``child_prefix`` children."""
    s = run.spans
    if s is None:
        return None
    own = s.self_seconds(name, child_prefix)
    return 1e3 * sum(own) / len(own) if own else None


def host_share(run, name: str) -> float | None:
    """% of the spans' slice with no ``name`` span open."""
    s = run.spans
    if s is None or s.window_s <= 0 or not s.named(name):
        return None
    return 100.0 * (1.0 - s.covered_seconds(name) / s.window_s)


def entry_self_ms(run, name: str) -> float | None:
    """Host ms a request spent inside the entry's calls (as the harness
    timed them) outside every ``name`` span."""
    s = run.spans
    if s is None or s.entry_s is None or s.calls <= 0 or not s.named(name):
        return None
    inner = sum(sp.duration_s for sp in s.named(name))
    return 1e3 * (s.entry_s - inner) / s.calls


def roofline(run, kernel: str, shapes) -> float | None:
    """% of the kernel's device time that its least time is: each call's
    least time, the larger of its bytes at peak bandwidth and its FLOPs at
    peak float32 rate, by the cost model in ``bench/cost/<kernel>.py``,
    summed over the profiled calls.  ``shapes(info)`` gives the model's
    arguments for one call's ``info``."""
    p = run.profile
    if p is None or p.calls <= 0:
        return None
    cost = run.cost(kernel)
    device_s = p.seconds_matching(cost.KERNELS)
    if device_s <= 0:
        return None
    least = 0.0
    for info in p.info:
        nbytes, flops = cost.cost(**shapes(info))
        least += max(nbytes / run.peaks["bytes_per_s"], flops / run.peaks["flops_per_s"])
    return 100.0 * least / device_s


def distinct_rows(cand: torch.Tensor) -> int:
    return int(torch.unique(cand).numel())
