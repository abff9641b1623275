"""Deterministic fault injection: scheduled faults over named sites.

The port's copy of ``repro.resilience.chaos``, cut to what the
streaming index instruments: the ``error`` and ``drop`` kinds at
``stream.apply`` and ``stream.flush``.  The other kinds (latency,
bitflip, nonfinite), probabilistic schedules and seeded drill plans
come with the sites that consume them, ROADMAP queue A items 9 and 10.

Code paths that can fail in production carry a *site* — a cheap
``chaos.hit("stream.apply")`` call (one global ``is None`` check when
no plan is installed) — and a test installs a :class:`FaultPlan` that
schedules faults against those sites:

    kind        effect at the site
    --------    ----------------------------------------------------
    error       ``chaos.hit(site)`` raises ChaosError (a crash point)
    drop        ``chaos.dropped(site)`` returns True — the operation
                is silently skipped (a lost flush)

A spec fires on the ``at``-th (0-based) matching access of its site,
once, so every chaos test replays exactly.

Instrumented sites:

    stream.apply      before an in-memory mutation      (error)
    stream.flush      delta seal                        (drop)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

__all__ = ["FaultSpec", "FaultPlan", "ChaosError", "active", "hit", "dropped"]


class ChaosError(RuntimeError):
    """An injected fault (the simulated crash/failure)."""

    def __init__(self, site: str, message: str = "injected fault"):
        self.site = site
        super().__init__(f"{message} at site {site!r}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where, what, and on which access it fires."""

    site: str
    kind: str  # "error" | "drop"
    at: int  # fire on the at-th (0-based) matching access

    def __post_init__(self):
        if self.kind not in ("error", "drop"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A deterministic schedule of faults over named sites."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = tuple(specs)
        self._hits = [0] * len(self.specs)  # matching accesses per spec
        self._fired = [0] * len(self.specs)

    def fired(self) -> dict[tuple[str, str], int]:
        """(site, kind) → times fired so far."""
        out: dict[tuple[str, str], int] = {}
        for spec, n in zip(self.specs, self._fired):
            if n:
                key = (spec.site, spec.kind)
                out[key] = out.get(key, 0) + n
        return out

    def due(self, site: str, kind: str) -> bool:
        """Advance the counters of the specs of (site, kind); True when
        one of them fires on this access."""
        fired = False
        for i, spec in enumerate(self.specs):
            if spec.site != site or spec.kind != kind:
                continue
            n = self._hits[i]
            self._hits[i] += 1
            if n == spec.at and not fired:
                self._fired[i] += 1
                fired = True
        return fired


_PLAN: FaultPlan | None = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Install ``plan`` for the duration of the block."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = prev


def hit(site: str) -> None:
    """Fault hook: raises ChaosError when a scheduled "error" fault
    fires (~free when no plan is installed — one global read)."""
    if _PLAN is not None and _PLAN.due(site, "error"):
        raise ChaosError(site)


def dropped(site: str) -> bool:
    """True when a scheduled "drop" fault fires — caller skips the op."""
    return _PLAN is not None and _PLAN.due(site, "drop")
