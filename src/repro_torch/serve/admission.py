"""Admission control: bounded queue, watermark backpressure, shedding.

The scheduler's queue is bounded (``max_queue`` requests across all
buckets).  Admission is a three-band policy on queue depth:

    depth < watermark·max_queue   → ADMIT   (normal service)
    watermark·max_queue ≤ depth
          < max_queue             → DEGRADE (graceful: serve from the
                                    cheaper tier — quant/ADC step or a
                                    clamped-k budget — instead of
                                    rejecting)
    depth ≥ max_queue             → SHED    (reject with a backpressure
                                    signal; the ticket resolves with
                                    status "shed", never silently)

``policy="shed"`` collapses the middle band into ADMIT, so requests
are either served at full quality or rejected — the right setting when
a degraded answer is worse than no answer (e.g. exact-recall SLOs).

``backpressure`` is the signal upstream callers poll to slow their
send rate before the hard limit starts shedding.
"""
from __future__ import annotations

__all__ = ["ADMIT", "DEGRADE", "SHED", "AdmissionController"]

ADMIT = "admit"
DEGRADE = "degrade"
SHED = "shed"


class AdmissionController:
    """Queue-depth-banded admission decisions."""

    def __init__(self, max_queue: int = 256, watermark: float = 0.75,
                 policy: str = DEGRADE):
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark must be in (0, 1], got {watermark}")
        if policy not in (DEGRADE, SHED):
            raise ValueError(f"policy must be 'degrade' or 'shed', "
                             f"got {policy!r}")
        self.max_queue = int(max_queue)
        self.watermark = float(watermark)
        self.policy = policy
        self._last_depth = 0

    @property
    def watermark_depth(self) -> int:
        return max(1, int(self.watermark * self.max_queue))

    def decide(self, depth: int) -> str:
        """ADMIT / DEGRADE / SHED for a request arriving at ``depth``."""
        self._last_depth = int(depth)
        if depth >= self.max_queue:
            return SHED
        if depth >= self.watermark_depth and self.policy == DEGRADE:
            return DEGRADE
        return ADMIT

    @property
    def backpressure(self) -> bool:
        """True once the last-seen depth crossed the watermark — the
        'slow down' signal upstream producers should poll."""
        return self._last_depth >= self.watermark_depth
