"""Bucketing and staging: the padded-shape palette behind the scheduler
(the port of ``repro.serve.batcher``).

Ragged traffic (any B, any k) is quantized onto a powers-of-two ladder
on both axes:

    k_pad = next power of two ≥ k   (clamped to [1, k_max])
    B_pad = next power of two ≥ #requests in the flush (≤ b_max)

giving a palette of at most log2(b_max)·log2(k_max) shapes.  The
reference compiles one jit program per shape; the port has no jit, but
the same bounded set of shapes reaches the card's kernels, and the
scheduler's compile counters (``ServeMetrics.on_compile``) count the
first sighting of each.

A :class:`Bucket` accumulates requests that share a k_pad (and service
tier) until it is full (``b_max``) or the oldest request's deadline
slack expires — deadline minus a service estimate the scheduler forms
from a per-slot EWMA of observed flush time scaled by the B_pad the
bucket would flush at right now; the scheduler then flushes it at the
smallest B_pad that fits.  That is continuous batching: a burst flushes
at full width immediately, a trickle flushes alone when its deadline
demands.

:class:`StagingBuffers` double-buffers the host side of the upload: two
pre-allocated float32 numpy arrays per (B_pad, d) alternate between
"being filled for flush i+1" and "owned by flush i", so staging never
allocates on the hot path.  The facade uploads the buffer it is handed
(``torch.from_numpy(q).to(device)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["PAD_DISTANCE", "pow2_ceil", "BucketPalette", "PendingRequest",
           "Bucket", "StagingBuffers"]

#: Distance reported for invalid (padded, indices == -1) result slots.
#: Large-but-finite: under an exp(-d)/softmax(-d) blend an invalid slot
#: gets weight 0 (like the facade's raw +inf padding), while staying
#: safe in 0·d expressions where +inf would produce NaN.  Callers must
#: still mask on ``valid`` — this only bounds the blast radius.
PAD_DISTANCE = np.float32(np.finfo(np.float32).max)


def pow2_ceil(x: int) -> int:
    """Smallest power of two ≥ x (x ≥ 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class BucketPalette:
    """The fixed ladder of padded shapes the scheduler may execute."""

    b_max: int = 64
    k_max: int = 128

    def __post_init__(self):
        if self.b_max < 1 or self.b_max != pow2_ceil(self.b_max):
            raise ValueError(f"b_max must be a power of two ≥ 1: {self.b_max}")
        if self.k_max < 1 or self.k_max != pow2_ceil(self.k_max):
            raise ValueError(f"k_max must be a power of two ≥ 1: {self.k_max}")

    def k_pad(self, k: int) -> int:
        if k > self.k_max:
            raise ValueError(f"k={k} exceeds the palette's k_max={self.k_max}")
        return pow2_ceil(k)

    def b_pad(self, n_requests: int) -> int:
        return min(pow2_ceil(n_requests), self.b_max)

    @property
    def shapes(self) -> list[tuple[int, int]]:
        """Every (B_pad, k_pad) the palette can emit — the compile
        ceiling for a whole serving session."""
        bs = [1 << i for i in range(self.b_max.bit_length())
              if (1 << i) <= self.b_max]
        ks = [1 << i for i in range(self.k_max.bit_length())
              if (1 << i) <= self.k_max]
        return [(b, k) for b in bs for k in ks]


@dataclasses.dataclass
class PendingRequest:
    """One admitted request waiting in a bucket."""

    id: int
    query: np.ndarray  # (d,) float32
    k: int  # SERVED k (≤ k_pad of its bucket; may be clamped by degrade)
    k_req: int  # the caller's requested k (response is padded back to it)
    deadline: float  # absolute, scheduler-clock seconds
    submit_t: float
    cache_key: Any = None  # fill the cache on completion
    degraded: bool = False


class Bucket:
    """Requests sharing (k_pad, tier), waiting to flush together."""

    __slots__ = ("k_pad", "tier", "requests")

    def __init__(self, k_pad: int, tier: str):
        self.k_pad = int(k_pad)
        self.tier = tier
        self.requests: list[PendingRequest] = []

    def __len__(self) -> int:
        return len(self.requests)

    def add(self, req: PendingRequest) -> None:
        self.requests.append(req)

    @property
    def oldest_deadline(self) -> float:
        return min(r.deadline for r in self.requests)

    def due(self, now: float, service_estimate_s: float) -> bool:
        """True when waiting any longer would push the oldest request
        past its deadline (deadline-aware continuous batching)."""
        if not self.requests:
            return False
        return now + service_estimate_s >= self.oldest_deadline

    def take_all(self) -> list[PendingRequest]:
        reqs, self.requests = self.requests, []
        return reqs


class StagingBuffers:
    """Double-buffered host staging for one (B_pad, d) shape."""

    __slots__ = ("buffers", "_next", "reuses")

    def __init__(self, b_pad: int, d: int):
        self.buffers = (np.zeros((b_pad, d), np.float32),
                        np.zeros((b_pad, d), np.float32))
        self._next = 0
        self.reuses = -2  # first two fills are the initial allocations

    def stage(self, rows: list[np.ndarray]) -> np.ndarray:
        """Copy ``rows`` into the free buffer (padding rows beyond
        len(rows) are zeroed) and hand it to the caller; the other
        buffer stays owned by the previous in-flight dispatch."""
        buf = self.buffers[self._next]
        self._next ^= 1
        self.reuses += 1
        n = len(rows)
        for i, r in enumerate(rows):
            buf[i] = r
        buf[n:] = 0.0
        return buf
