"""Deterministic fault injection: seeded plans over named sites.

The port's copy of ``repro.resilience.chaos``: the same kinds, sites,
schedules and seeded drill plans, so one plan replays the same faults
in either framework.

Failure modes are first-class, repeatable test parameters.  Code paths
that can fail in production carry a *site* — a cheap
``chaos.hit("wal.append")`` call (one global ``is None`` check when no
plan is installed) — and a test or drill installs a :class:`FaultPlan`
that schedules faults against those sites:

    kind        effect at the site
    --------    ----------------------------------------------------
    error       raise ChaosError (a crash / kill point)
    latency     sleep ``latency_s``; when the caller passed a budget
                and the injected latency exceeds it, sleep only the
                budget and raise ChaosLatencyExceeded — the model of
                a straggler call abandoned at its deadline
    bitflip     flip ``flip_bits`` random bits of a byte payload
                (``chaos.transform`` sites — checksums must catch it)
    drop        ``chaos.dropped(site)`` returns True — the operation
                is silently skipped (a lost flush)
    nonfinite   ``chaos.poisoned(site)`` returns True — the caller
                substitutes a NaN/Inf payload (a poisoned query)

Schedules are deterministic: ``at=n`` fires on the n-th (0-based)
matching access of the site, ``prob=p`` fires per access from the
plan's seeded RNG, and ``times`` caps total firings.  A plan's whole
trajectory is a pure function of (specs, seed, access sequence) — the
reference's, for the same plan.

Instrumented sites:

    wal.append        before a WAL record is written   (kill point,
                                                        straggler)
    stream.apply      after the WAL write, before the in-memory
                      mutation                          (kill point)
    stream.flush      delta seal                        (drop)
    snapshot.write    before snapshot payload files are written
    snapshot.commit   before the COMMIT marker
    segment.load      snapshot segment bytes on read    (bitflip)
    serve.flush       scheduler bucket flush            (drop)
    serve.search      primary-tier index call           (error/latency)
    serve.degraded    degraded-tier index call          (error/latency)
    serve.cache       hot-query cache probe             (error)
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Iterable, Sequence

__all__ = ["FaultSpec", "FaultPlan", "ChaosError", "ChaosLatencyExceeded",
           "install", "uninstall", "active", "current_plan", "hit",
           "transform", "dropped", "poisoned", "precise_sleep", "KNOWN_SITES"]

#: the last stretch of a ``precise_sleep`` is spun: on an H100 host
#: ``time.sleep`` overshot a 1.6-ms request by 0.57 ms and a 0.128-ms
#: one by 1.0 ms at the median (scripts/torch_drill_timing.py)
SPIN_S = 2e-3


def precise_sleep(seconds: float) -> None:
    """Block for ``seconds`` and no longer: ``time.sleep`` up to
    ``SPIN_S`` before the deadline, then spin on ``perf_counter``.  An
    injected straggler and a retry backoff last what the plan and the
    serve config say, not what the OS timer adds to them."""
    deadline = time.perf_counter() + seconds
    if seconds > SPIN_S:
        time.sleep(seconds - SPIN_S)
    while time.perf_counter() < deadline:
        pass

#: every site the codebase instruments, with the fault kinds that are
#: meaningful there — the vocabulary ``FaultPlan.seeded`` draws from
KNOWN_SITES: dict[str, tuple[str, ...]] = {
    "wal.append": ("error", "latency"),
    "stream.apply": ("error",),
    "stream.flush": ("drop",),
    "snapshot.write": ("error",),
    "snapshot.commit": ("error",),
    "segment.load": ("bitflip",),
    "serve.flush": ("drop",),
    "serve.search": ("error", "latency"),
    "serve.degraded": ("error", "latency"),
    "serve.cache": ("error",),
}


class ChaosError(RuntimeError):
    """An injected fault (the simulated crash/failure)."""

    def __init__(self, site: str, message: str = "injected fault"):
        self.site = site
        super().__init__(f"{message} at site {site!r}")


class ChaosLatencyExceeded(ChaosError):
    """An injected straggler exceeded the caller's budget — the model
    of a timed-out call abandoned at its deadline."""

    def __init__(self, site: str, latency_s: float, budget_s: float):
        self.latency_s = latency_s
        self.budget_s = budget_s
        super().__init__(site, f"injected {latency_s * 1e3:.1f}ms straggler "
                               f"past {budget_s * 1e3:.1f}ms budget")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where, what, and when it fires."""

    site: str
    kind: str  # "error" | "latency" | "bitflip" | "drop" | "nonfinite"
    at: int | None = None  # fire on the at-th (0-based) matching access
    prob: float = 0.0  # per-access probability when ``at`` is None
    times: int = 1  # total firing cap (<=0 → unlimited)
    latency_s: float = 0.0  # kind="latency"
    flip_bits: int = 1  # kind="bitflip"

    def __post_init__(self):
        if self.kind not in ("error", "latency", "bitflip", "drop",
                             "nonfinite"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


#: accessor → the fault kinds it consumes (each accessor advances only
#: its own specs' hit counters, so mixing accessors at one site stays
#: deterministic)
_ACCESSOR_KINDS = {
    "hit": ("error", "latency"),
    "transform": ("bitflip",),
    "dropped": ("drop",),
    "poisoned": ("nonfinite",),
}


class FaultPlan:
    """A deterministic, seeded schedule of faults over named sites."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._hits = [0] * len(self.specs)  # matching accesses per spec
        self._fired = [0] * len(self.specs)
        self.sleep = precise_sleep  # injectable for tests

    # -- bookkeeping -----------------------------------------------------

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

    # -- accessors -------------------------------------------------------

    def on_hit(self, site: str, budget_s: float | None = None) -> None:
        spec = self._due(site, _ACCESSOR_KINDS["hit"])
        if spec is None:
            return
        if spec.kind == "error":
            raise ChaosError(site)
        # latency: sleep the straggler, but never past the caller's
        # budget — past it the call is modeled as abandoned
        if budget_s is not None and spec.latency_s > budget_s:
            self.sleep(budget_s)
            raise ChaosLatencyExceeded(site, spec.latency_s, budget_s)
        self.sleep(spec.latency_s)

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

    def on_poisoned(self, site: str) -> bool:
        return self._due(site, _ACCESSOR_KINDS["poisoned"]) is not None

    # -- constructors ----------------------------------------------------

    @classmethod
    def seeded(cls, seed: int, sites: Iterable[str] | None = None, *,
               prob: float = 0.05, times: int = 3,
               latency_s: float = 0.05) -> "FaultPlan":
        """A randomized drill plan: for each site, one probabilistic
        spec per kind that site supports.  Same seed → same plan AND
        same firing trajectory."""
        specs = []
        for site in (sites if sites is not None else sorted(KNOWN_SITES)):
            for kind in KNOWN_SITES.get(site, ("error",)):
                specs.append(FaultSpec(site, kind, prob=prob, times=times,
                                       latency_s=latency_s))
        return cls(specs, seed=seed)


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


def hit(site: str, budget_s: float | None = None) -> None:
    """Fault hook: raises / sleeps per the installed plan (~free when
    none is installed — one global read)."""
    if _PLAN is not None:
        _PLAN.on_hit(site, budget_s=budget_s)


def transform(site: str, data: bytes) -> bytes:
    """Byte-corruption hook: returns ``data``, possibly bit-flipped."""
    if _PLAN is not None:
        return _PLAN.on_bytes(site, data)
    return data


def dropped(site: str) -> bool:
    """True when a scheduled "drop" fault fires — caller skips the op."""
    return _PLAN is not None and _PLAN.on_dropped(site)


def poisoned(site: str) -> bool:
    """True when a scheduled "nonfinite" fault fires — caller poisons
    its payload (e.g. substitutes NaN into a query)."""
    return _PLAN is not None and _PLAN.on_poisoned(site)
