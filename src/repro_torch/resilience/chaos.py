"""Deterministic fault injection: seeded plans over named sites.

The port's copy of ``repro.resilience.chaos``, cut to the kinds its
sites consume: ``error``, ``drop`` and ``bitflip``.  The latency and
nonfinite kinds, and the seeded drill plans, come with the serving
stack that consumes them (ROADMAP queue A item 9).

Code paths that can fail in production carry a *site* — a cheap
``chaos.hit("wal.append")`` call (one global ``is None`` check when no
plan is installed) — and a test installs a :class:`FaultPlan` that
schedules faults against those sites:

    kind        effect at the site
    --------    ----------------------------------------------------
    error       ``chaos.hit(site)`` raises ChaosError (a crash point)
    bitflip     ``chaos.transform(site, data)`` flips ``flip_bits``
                random bits of a byte payload (checksums must catch it)
    drop        ``chaos.dropped(site)`` returns True — the operation
                is silently skipped (a lost flush)

Schedules are deterministic: ``at=n`` fires on the n-th (0-based)
matching access of the site, ``prob=p`` fires per access from the
plan's seeded RNG, and ``times`` caps total firings.  A plan's whole
trajectory is a pure function of (specs, seed, access sequence) — the
reference's, for the same plan.

Instrumented sites:

    wal.append        before a WAL record is written   (kill point)
    stream.apply      after the WAL write, before the in-memory
                      mutation                          (kill point)
    stream.flush      delta seal                        (drop)
    snapshot.write    before snapshot payload files are written
    snapshot.commit   before the COMMIT marker
    segment.load      snapshot segment bytes on read    (bitflip)
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Sequence

__all__ = ["FaultSpec", "FaultPlan", "ChaosError", "install", "uninstall",
           "active", "current_plan", "hit", "transform", "dropped"]


class ChaosError(RuntimeError):
    """An injected fault (the simulated crash/failure)."""

    def __init__(self, site: str, message: str = "injected fault"):
        self.site = site
        super().__init__(f"{message} at site {site!r}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where, what, and when it fires."""

    site: str
    kind: str  # "error" | "bitflip" | "drop"
    at: int | None = None  # fire on the at-th (0-based) matching access
    prob: float = 0.0  # per-access probability when ``at`` is None
    times: int = 1  # total firing cap (<=0 → unlimited)
    flip_bits: int = 1  # kind="bitflip"

    def __post_init__(self):
        if self.kind not in ("error", "bitflip", "drop"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


#: accessor → the fault kinds it consumes (each accessor advances only
#: its own specs' hit counters, so mixing accessors at one site stays
#: deterministic)
_ACCESSOR_KINDS = {
    "hit": ("error",),
    "transform": ("bitflip",),
    "dropped": ("drop",),
}


class FaultPlan:
    """A deterministic, seeded schedule of faults over named sites."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
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

    def _due(self, site: str, kinds: tuple[str, ...]) -> FaultSpec | None:
        """Advance counters for matching specs; return the first spec
        that fires on this access (at most one per access)."""
        fired = None
        for i, spec in enumerate(self.specs):
            if spec.site != site or spec.kind not in kinds:
                continue
            n = self._hits[i]
            self._hits[i] += 1
            if spec.times > 0 and self._fired[i] >= spec.times:
                continue
            due = (n == spec.at if spec.at is not None
                   else self._rng.random() < spec.prob)
            if due and fired is None:
                self._fired[i] += 1
                fired = spec
        return fired

    def on_hit(self, site: str) -> None:
        if self._due(site, _ACCESSOR_KINDS["hit"]) is not None:
            raise ChaosError(site)

    def on_bytes(self, site: str, data: bytes) -> bytes:
        spec = self._due(site, _ACCESSOR_KINDS["transform"])
        if spec is None or not data:
            return data
        buf = bytearray(data)
        for _ in range(max(spec.flip_bits, 1)):
            pos = self._rng.randrange(len(buf))
            buf[pos] ^= 1 << self._rng.randrange(8)
        return bytes(buf)

    def on_dropped(self, site: str) -> bool:
        return self._due(site, _ACCESSOR_KINDS["dropped"]) is not None


# -- process-global installation --------------------------------------------

_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def current_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Install ``plan`` for the duration of the block."""
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev) if prev is not None else uninstall()


def hit(site: str) -> None:
    """Fault hook: raises ChaosError when a scheduled "error" fault
    fires (~free when no plan is installed — one global read)."""
    if _PLAN is not None:
        _PLAN.on_hit(site)


def transform(site: str, data: bytes) -> bytes:
    """Byte-corruption hook: returns ``data``, possibly bit-flipped."""
    if _PLAN is not None:
        return _PLAN.on_bytes(site, data)
    return data


def dropped(site: str) -> bool:
    """True when a scheduled "drop" fault fires — caller skips the op."""
    return _PLAN is not None and _PLAN.on_dropped(site)
