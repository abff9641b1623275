"""Readers of the program's own spans beside ``bench/lib/readers.py``'s:
counted in the span slice, and laid over the device's idle gaps where a
profile holds them as ranges.

With tracing off under ``torch.profiler``, as in the profiled slice, the
program opens a profiler range (a host ``cpu_op`` event) at each span site
and synchronizes nothing, so the profile shows which span the host was in
while the device waited.  Each reader returns None where its run holds
nothing to read: no spans of the names asked for (a program without
them), no device events (the CPU), no calls.
"""
from __future__ import annotations

from bench.lib.profiling import Profile, _union

__all__ = ["spans_per_call", "idle_ms", "idle_by_span"]


def spans_per_call(run, prefix: str) -> float | None:
    """Spans of the span slice whose names start with ``prefix``, over the
    slice's calls."""
    s = run.spans
    if s is None or s.calls <= 0:
        return None
    count = sum(sp.name.startswith(prefix) for sp in s.spans)
    return count / s.calls if count else None


def _intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _complement(intervals, t0: float, t1: float):
    out, at = [], t0
    for a, b in intervals:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def idle_ms(profile: Profile | None, names, outside: str | None = None,
            per: str | None = None) -> float | None:
    """Device-idle ms inside the union of the host ranges named in
    ``names`` and outside every range whose name starts with ``outside``,
    over the profile's calls, or over its ranges named ``per`` where
    given (a flush's: ``per="serve.flush"``)."""
    p = profile
    if p is None or not p.device:
        return None
    names = set(names)
    inside = _union([(e.t0, e.t1) for e in p.host if e.name in names])
    count = p.calls if per is None else sum(e.name == per for e in p.host)
    if not inside or count <= 0:
        return None
    if outside is not None:
        skip = _union([(e.t0, e.t1) for e in p.host if e.name.startswith(outside)])
        inside = _intersect(inside, _complement(skip, p.t0, p.t1))
    idle = _intersect(inside, p.gaps())
    return sum(b - a for a, b in idle) / 1e3 / count


def idle_by_span(profile: Profile, names) -> dict[str, float]:
    """The device's idle µs in the profile's window, each instant credited
    to the innermost host range named in ``names`` open then (``""``
    where none is).  The program's ranges nest, as its spans do."""
    p = profile
    names = set(names)
    marks = []
    for e in p.host:
        if e.name in names:  # at one instant: closes, then the outer opens first
            marks.append((e.t0, 1, -e.t1, e.name))
            marks.append((e.t1, 0, 0.0, e.name))
    marks.sort(key=lambda m: m[:3])
    pieces, stack, at = [], [], p.t0  # the window cut where the innermost range changes
    for t, opens, _, name in marks:
        if t > at:
            pieces.append((at, t, stack[-1] if stack else ""))
            at = t
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    pieces.append((at, p.t1, stack[-1] if stack else ""))
    gaps, out, g = p.gaps(), {}, 0
    for lo, hi, name in pieces:
        while g < len(gaps) and gaps[g][1] <= lo:
            g += 1
        j = g
        while j < len(gaps) and gaps[j][0] < hi:
            part = min(hi, gaps[j][1]) - max(lo, gaps[j][0])
            if part > 0:
                out[name] = out.get(name, 0.0) + part
            j += 1
    return out
