"""Trace exporters: Chrome-trace/Perfetto JSON + flat stage summaries
(the port's copy of ``repro.obs.export``).

Two consumers:

  * a human opens the Chrome-trace JSON in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing`` and reads the
    span tree on a timeline — each kernel span's ``args`` carries its
    roofline placement (modeled bytes/FLOPs, achieved GB/s and
    GFLOP/s, memory- vs compute-bound);
  * a benchmark embeds :func:`stage_summary`'s flat per-stage
    aggregate, so a perf record says *where* time went, not just
    end-to-end medians.

The Chrome-trace format used is the JSON object form: a top-level
``traceEvents`` list of complete ("ph": "X") events with microsecond
``ts``/``dur`` — the stable subset every trace viewer accepts.
"""
from __future__ import annotations

import json
import math
from typing import Iterable, Sequence

from . import roofline
from .trace import Span, Trace

__all__ = ["to_chrome_trace", "save_chrome_trace", "validate_chrome_trace",
           "stage_summary", "coverage"]


def _spans_of(spans) -> list[Span]:
    if isinstance(spans, Trace):
        return spans.spans
    return list(spans)


def _sanitize(value):
    """JSON-safe attr values (numpy scalars → python, inf → str)."""
    if hasattr(value, "item"):
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return str(value)


def to_chrome_trace(spans, *, pid: int = 1, tid: int = 1,
                    process_name: str = "repro_torch",
                    peaks: roofline.DevicePeaks | None = None) -> dict:
    """Render spans as a Chrome-trace JSON object.

    Every span becomes one complete event; spans whose attrs carry
    modeled ``bytes``+``flops`` (the kernel spans recorded by
    ``repro_torch.kernels.ops``) additionally get their roofline placement
    (:func:`repro_torch.obs.roofline.achieved`) merged into ``args``.
    Timestamps are rebased so the earliest span starts at ts=0.
    """
    spans = _spans_of(spans)
    t_base = min((s.t0 for s in spans), default=0.0)
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": process_name},
    }]
    for s in spans:
        args = {k: _sanitize(v) for k, v in s.attrs.items()}
        if "bytes" in s.attrs and "flops" in s.attrs and s.duration_s > 0:
            cost = roofline.KernelCost(int(s.attrs["bytes"]),
                                       int(s.attrs["flops"]))
            args.update(_sanitize(
                roofline.achieved(cost, s.duration_s, peaks)))
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": round((s.t0 - t_base) * 1e6, 3),
            "dur": round(s.duration_us, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome_trace(path: str, spans, **kw) -> str:
    """Write :func:`to_chrome_trace` output to ``path``; returns it."""
    obj = to_chrome_trace(spans, **kw)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    return path


def validate_chrome_trace(obj: dict) -> None:
    """Raise ``ValueError`` unless ``obj`` is a structurally valid
    Chrome-trace JSON object (the subset this exporter emits): a
    ``traceEvents`` list whose complete events carry string names,
    known phases, and non-negative numeric ``ts``/``dur``."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("missing top-level traceEvents")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for req in ("name", "ph", "pid", "tid"):
            if req not in ev:
                raise ValueError(f"event {i} missing {req!r}")
        if not isinstance(ev["name"], str):
            raise ValueError(f"event {i} name is not a string")
        if ev["ph"] not in ("X", "B", "E", "M", "i", "C"):
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] == "X":
            for fld in ("ts", "dur"):
                v = ev.get(fld)
                if not isinstance(v, (int, float)) or v < 0 \
                        or not math.isfinite(v):
                    raise ValueError(f"event {i} bad {fld}: {v!r}")
        if "args" in ev:
            json.dumps(ev["args"])  # must be serializable


def coverage(spans) -> float:
    """Fraction of root-span wall time covered by direct children —
    the "did the spans account for the measured time" check (the
    acceptance bar is ≥0.95 on the traced pipelines).  A leaf root is
    its own measurement and counts as fully covered; returns 1.0 for
    an empty trace."""
    spans = _spans_of(spans)
    root_total = child_total = 0.0
    by_parent: dict[int, float] = {}
    for i, s in enumerate(spans):
        if s.parent >= 0:
            by_parent[s.parent] = by_parent.get(s.parent, 0.0) + s.duration_s
    for i, s in enumerate(spans):
        if s.parent == -1:
            root_total += s.duration_s
            covered = by_parent.get(i)
            child_total += s.duration_s if covered is None \
                else min(covered, s.duration_s)
    if root_total <= 0.0:
        return 1.0
    return child_total / root_total


def stage_summary(spans, *, peaks: roofline.DevicePeaks | None = None) -> dict:
    """Flat per-stage aggregate for BENCH embedding.

    Groups spans by name; per stage: call count, total/mean µs, and —
    when the stage's spans carry roofline models — summed bytes/FLOPs,
    model arithmetic intensity, achieved GB/s / GFLOP/s over the
    stage's total time and the bound classification.  The envelope
    records total root wall time, span count, and :func:`coverage`.
    """
    spans = _spans_of(spans)
    stages: dict[str, dict] = {}
    for s in spans:
        st = stages.setdefault(s.name, {"count": 0, "total_us": 0.0,
                                        "bytes": 0, "flops": 0})
        st["count"] += 1
        st["total_us"] += s.duration_us
        if "bytes" in s.attrs and "flops" in s.attrs:
            st["bytes"] += int(s.attrs["bytes"])
            st["flops"] += int(s.attrs["flops"])
    for name, st in stages.items():
        st["total_us"] = round(st["total_us"], 1)
        st["mean_us"] = round(st["total_us"] / max(st["count"], 1), 1)
        if st["bytes"] > 0 and st["flops"] > 0:
            cost = roofline.KernelCost(st["bytes"], st["flops"])
            st.update(roofline.achieved(cost, st["total_us"] / 1e6, peaks))
        else:  # non-kernel stage: no model to place on the roofline
            st.pop("bytes"), st.pop("flops")
    wall_us = sum(s.duration_us for s in spans if s.parent == -1)
    return {
        "wall_us": round(wall_us, 1),
        "n_spans": len(spans),
        "coverage": round(coverage(spans), 4),
        "stages": stages,
    }
