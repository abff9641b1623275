"""What a traced run reads: a device profile of a slice of traffic, taken
by ``torch.profiler``, and the program's own spans over another slice.

The profile keeps the slice's device operations (kernels, copies and
memsets, with their start and end on the device's clock) and the host's
operations (torch operators, the harness's annotations, CUDA runtime
calls), inside the ``bench.window`` annotation that bounds the slice.
From them come the device's busy time, its idle gaps, each labelled with
what the host was doing, and the time of the kernels a cost model names.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["Event", "Profile", "SpanSlice", "profile_slice", "csrc_kernel_names",
           "short_name"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
#: small launches and a pause before the slice: the first launches of a
#: trace were seen to go unrecorded
PAUSE_S = 0.005


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    t0: float  # microseconds
    t1: float


def short_name(name: str) -> str:
    """A kernel's name without its signature: ``void f<T>(int)`` -> ``f<T>``."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Profile:
    """One profiled slice: ``calls`` calls of the cell's entry and what each
    was (``info``), with the device and host events inside its window."""

    device: list[Event]
    host: list[Event]
    t0: float
    t1: float
    calls: int = 0
    info: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return max(self.t1 - self.t0, 0.0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union([(max(e.t0, self.t0), min(e.t1, self.t1)) for e in self.device
                       if e.t1 > self.t0 and e.t0 < self.t1])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> list[Event]:
        return [e for e in self.device if e.cat == "kernel"]

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose names match any of the
        regular expressions ``patterns`` (searched in the full name)."""
        rx = [re.compile(p) for p in patterns]
        return sum(e.t1 - e.t0 for e in self.kernels()
                   if any(r.search(e.name) for r in rx)) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """Idle stretches of the device inside the window, in microseconds."""
        out, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def host_label(self, t: float) -> str:
        """The innermost host operation open at time ``t``."""
        best = None
        for e in self.host:
            if e.t0 <= t <= e.t1 and e.name != WINDOW:
                if best is None or e.t0 >= best.t0:
                    best = e
        return best.name[:96] if best is not None else "host: python, no torch call"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for e in self.device:
            key = short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + (e.t1 - e.t0) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}


@dataclasses.dataclass
class SpanSlice:
    """The program's spans over one slice of traffic (``time.perf_counter``
    seconds), with the calls and answered requests the slice made and, where
    the harness timed them, the host seconds spent inside the entry's calls
    (``entry_s``)."""

    spans: list
    t0: float
    t1: float
    calls: int = 0
    answered: int = 0
    entry_s: float | None = None

    @property
    def window_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def self_seconds(self, name: str, child_prefix: str) -> list[float]:
        """Each ``name`` span's duration less its direct children whose
        names start with ``child_prefix``."""
        index = {id(s): i for i, s in enumerate(self.spans)}
        child = [0.0] * len(self.spans)
        for s in self.spans:
            if s.parent >= 0 and s.name.startswith(child_prefix):
                child[s.parent] += s.duration_s
        return [s.duration_s - child[index[id(s)]] for s in self.named(name)]

    def covered_seconds(self, name: str) -> float:
        """Seconds of the slice inside at least one ``name`` span."""
        iv = _union([(max(s.t0, self.t0), min(s.t1, self.t1))
                     for s in self.named(name) if s.t1 > self.t0 and s.t0 < self.t1])
        return sum(b - a for a, b in iv)


def profile_slice(fn, device: torch.device) -> Profile:
    """Run ``fn()`` (which returns ``(calls, info)``) under torch.profiler
    inside a ``bench.window`` annotation, synchronizing before it closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        x = torch.zeros(256, device=device)
        for _ in range(4):
            x += 1
        if cuda:
            torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        with record_function(WINDOW):
            calls, info = fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    finally:
        os.unlink(path)
    device_ev, host_ev, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(str(e.get("name", "")), str(e.get("cat", "")),
                   float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if ev.cat in DEVICE_CATS:
            device_ev.append(ev)
        elif ev.cat in HOST_CATS:
            if ev.name == WINDOW and ev.cat == "user_annotation":
                window = ev
            host_ev.append(ev)
    if window is None:
        raise RuntimeError("profile: the bench.window annotation is missing from the trace")
    inside = [e for e in device_ev if e.t1 > window.t0 and e.t0 < window.t1]
    host = [e for e in host_ev if e.t1 > window.t0 and e.t0 < window.t1]
    return Profile(inside, host, window.t0, window.t1, calls, info)


def csrc_kernel_names(src_root: Path) -> set[str]:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    rx = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    for path in sorted(Path(src_root).glob("*.cu")):
        names.update(rx.findall(path.read_text()))
    return names
