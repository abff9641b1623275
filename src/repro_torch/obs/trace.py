"""Hierarchical span tracer — where wall-clock time actually goes (the
port's copy of ``repro.obs.trace``).

The paper argues about query cost with a model (Table 2, Eq. 7-10);
``WorkStats`` counts the model's units (distance computations).  This
module records the third leg: measured wall time, per pipeline stage,
as a tree of :class:`Span`s.

Design constraints (DESIGN.md §12):

  * ~zero cost disabled.  One module-level boolean guards everything;
    ``span()`` returns a shared no-op context manager without touching
    the collector, so instrumented hot paths pay one attribute load
    and one branch.
  * safe around asynchronous launches.  A CUDA kernel returns before
    the card finishes; a span that closes without synchronizing would
    attribute device time to whichever span happens to block later.
    ``block()`` synchronizes the stream of every CUDA tensor it is given
    **only while tracing** (no-op otherwise).
    The kernel-dispatch instrumentation in ``repro_torch.kernels.ops``
    opens its ``kernel.<op>`` span only while tracing, so with tracing
    off a wrapper pays one boolean check and makes no host sync.
  * nestable.  Spans form a tree via a per-tracer stack: the
    streaming index's ``stream.search`` span contains one
    ``stream.segment`` span per segment (each a facade's
    ``index.search`` with its ``ann.*`` or ``quant.*`` stage spans),
    ``stream.delta`` and ``stream.merge``; stage spans contain the
    per-kernel spans carrying roofline attrs.
  * the reference's one-jit-call stages.  Where the reference bounds a
    whole jit'd pipeline by one span (the unfused flat query), no span
    inside it exists there; :func:`paused` gives the port's eager twin
    the same tree.  The port has no jit, so it has no ``concrete()``.

Usage::

    from repro_torch.obs import trace

    with trace.trace() as tr:           # enables, collects, disables
        index.search(Q, k=10)
    tr.spans                            # the collected Span tree
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Iterator

import torch

__all__ = ["Span", "Tracer", "Trace", "get_tracer", "enabled", "enable",
           "disable", "span", "add_span", "block", "current_span", "paused",
           "trace"]

#: the one flag every instrumented call site checks first (module
#: attribute load + truth test — the entire disabled-mode cost)
_ENABLED: bool = False


@dataclasses.dataclass
class Span:
    """One timed region.  ``parent`` indexes the tracer's span list
    (-1 for roots); ``attrs`` carries whatever the site recorded —
    kernel spans get modeled ``bytes``/``flops`` (see
    ``repro_torch.obs.roofline``), the streaming index's spans sizes and
    counts."""

    name: str
    t0: float  # perf_counter seconds
    t1: float
    parent: int
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    @property
    def duration_us(self) -> float:
        return self.duration_s * 1e6


class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-global span collector (one per process is the intended
    use; tests may instantiate their own).  Bounded: past ``max_spans``
    new spans are counted in ``dropped`` instead of stored, so a traced
    long-running server cannot grow without bound."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = int(max_spans)
        self.spans: list[Span] = []
        self.dropped = 0
        self._stack: list[int] = []

    # -- recording -------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span | None]:
        """Open a child span of whatever span is currently on the
        stack.  The span's end time is stamped at exit — call
        :func:`block` on CUDA results inside, or the device work
        escapes the span."""
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            yield None
            return
        idx = len(self.spans)
        parent = self._stack[-1] if self._stack else -1
        s = Span(name, time.perf_counter(), 0.0, parent, attrs)
        self.spans.append(s)
        self._stack.append(idx)
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            self._stack.pop()

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> Span | None:
        """Record a span with explicit perf_counter endpoints (e.g. a
        request's queue wait, whose start predates the current span).
        Parented to the currently open span."""
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        parent = self._stack[-1] if self._stack else -1
        s = Span(name, float(t0), float(t1), parent, attrs)
        self.spans.append(s)
        return s

    # -- draining --------------------------------------------------------

    def drain(self) -> list[Span]:
        """Return collected spans and reset the collector."""
        out, self.spans = self.spans, []
        self._stack.clear()
        self.dropped = 0
        return out

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent == -1]


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def span(name: str, **attrs):
    """Module-level span helper: a real span while tracing, the shared
    no-op context manager otherwise."""
    if not _ENABLED:
        return _NULL_SPAN
    return _TRACER.span(name, **attrs)


def add_span(name: str, t0: float, t1: float, **attrs) -> Span | None:
    if not _ENABLED:
        return None
    return _TRACER.add_span(name, t0, t1, **attrs)


def current_span() -> Span | None:
    """The innermost open span while tracing, else None — how a kernel
    wrapper refines its span's model from what the call did."""
    if not _ENABLED or not _TRACER._stack:
        return None
    return _TRACER.spans[_TRACER._stack[-1]]


@contextmanager
def paused() -> Iterator[None]:
    """Record no span in the body (tracing resumes after it): the
    stages the reference runs as one jit call have no spans inside."""
    global _ENABLED
    was, _ENABLED = _ENABLED, False
    try:
        yield
    finally:
        _ENABLED = was


def block(*values):
    """Synchronize the stream of every CUDA tensor in ``values`` while
    tracing (no-op otherwise).  Returns the single value or the tuple,
    so call sites can wrap returns: ``return block(x)``."""
    if _ENABLED:
        for v in values:
            _block_one(v)
    return values[0] if len(values) == 1 else values


def _block_one(v) -> None:
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            torch.cuda.current_stream(v.device).synchronize()
    elif isinstance(v, (tuple, list)):
        for item in v:
            _block_one(item)


@dataclasses.dataclass
class Trace:
    """The result of one ``with trace.trace()`` region."""

    spans: list[Span] = dataclasses.field(default_factory=list)
    dropped: int = 0

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent == -1]


@contextmanager
def trace() -> Iterator[Trace]:
    """Enable tracing for the body, then hand the collected spans back
    on the yielded :class:`Trace`.  Re-entrant uses nest: only the
    outermost exit disables tracing and drains the collector."""
    tr = Trace()
    was_enabled = _ENABLED
    mark = len(_TRACER.spans)
    enable()
    try:
        yield tr
    finally:
        if not was_enabled:
            disable()
            tr.spans = _TRACER.drain()
            tr.dropped = 0
        else:  # nested: take only the spans this region added, with
            # parent indices rebased onto the slice
            sliced = _TRACER.spans[mark:]
            tr.spans = [
                dataclasses.replace(
                    s, parent=(s.parent - mark if s.parent >= mark else -1))
                for s in sliced
            ]
            tr.dropped = _TRACER.dropped
