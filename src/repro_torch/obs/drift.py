"""Streaming projection-drift monitor: does build-time calibration still fit?

The port's copy of ``repro.obs.drift``, cut to what the streaming
index uses: it takes rows already projected and publishes no gauges
(the projection family argument and the metrics registry come with the
rest of ``obs``, ROADMAP queue A item 8); ``report()`` reads every
score.

Eq. 9/10 calibration (the select kernel's τ₀ seed, the Eq. 10 candidate
budget, the quant codebook ranges) is solved ONCE from the distribution
the index was built on.  A streaming index keeps ingesting; when the
live distribution walks away from the build-time one, the χ²(m) model's
constants quietly stop matching reality — recall erodes with no error
anywhere (Jafari et al., arXiv 2006.11285, measure exactly this).  The
monitor watches two cheap projection-space signals and raises a
"recalibrate" flag when either moves:

  * **projected-coordinate moments.**  A Welford accumulator over the
    baseline (build/first-N) rows' projected coordinates, and an EWMA
    over live inserts.  Drift statistics: the standardized mean shift
    ``|μ_live − μ_base| / σ_base`` and the log variance ratio
    ``|log(σ²_live / σ²_base)|``.  Mean-zero Gaussian projections make
    both ≈0 for stationary data regardless of the raw data's scale.
  * **survivor-count occupancy.**  The radius-select kernel reports
    per-query survivor counts (realized T, the
    ``WorkStats.candidates_selected``).  Their histogram over bins of
    the T budget is the live image of the rung-ladder occupancy the
    kernel's τ ladder was sized for; total-variation distance between
    the baseline and live occupancy histograms catches distribution
    shifts that leave the first two moments alone.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["DriftMonitor", "DriftReport"]


class _Welford:
    """Numerically stable running mean/variance (scalar stream)."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def add_batch(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float64).reshape(-1)
        if x.size == 0:
            return
        n_b, mean_b = x.size, float(x.mean())
        m2_b = float(((x - mean_b) ** 2).sum())
        if self.n == 0:
            self.n, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        delta = mean_b - self.mean
        tot = self.n + n_b
        self.m2 += m2_b + delta * delta * self.n * n_b / tot
        self.mean += delta * n_b / tot
        self.n = tot

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Drift statistics at one point in time (all ≈0 when stationary)."""

    baseline_rows: int
    live_rows: int
    mean_shift: float  # |EWMA(live mean) − base mean| / base std
    var_ratio: float  # |log(EWMA(live var) / base var)|
    occupancy_tv: float  # TV distance, live vs baseline survivor histogram
    recalibrate: bool

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """Track projection-space statistics across inserts/compactions.

    Args:
      baseline_rows: first N observed rows freeze the baseline; later
        rows feed the live EWMA.  (Compaction does not reset the
        baseline — drift is measured against *build-time* calibration,
        which is what Eq. 9/10 solved against.)
      ewma_alpha: per-batch smoothing for the live moments.
      occupancy_bins: survivor-count histogram bins over [0, T].
      mean_tol / var_tol / tv_tol: per-signal recalibrate thresholds.
    """

    def __init__(self, *, baseline_rows: int = 256,
                 ewma_alpha: float = 0.2, occupancy_bins: int = 8,
                 mean_tol: float = 0.5, var_tol: float = 0.69,
                 tv_tol: float = 0.35):
        self.baseline_rows = int(baseline_rows)
        self.ewma_alpha = float(ewma_alpha)
        self.occupancy_bins = int(occupancy_bins)
        self.mean_tol = float(mean_tol)
        self.var_tol = float(var_tol)
        self.tv_tol = float(tv_tol)
        self._base = _Welford()
        self._live_rows = 0
        self._ewma_mean: float | None = None
        self._ewma_var: float | None = None
        self._occ_base = np.zeros(self.occupancy_bins, np.float64)
        self._occ_live = np.zeros(self.occupancy_bins, np.float64)
        self._occ_live_n = 0

    # -- data-side signal -------------------------------------------------

    def observe_rows(self, proj: np.ndarray) -> None:
        """Feed inserted rows' projected coordinates (n, m)."""
        proj = np.asarray(proj, np.float32)
        if proj.ndim == 1:
            proj = proj[None]
        if proj.shape[0] == 0:
            return
        coords = np.asarray(proj, np.float64).reshape(-1)
        if self._base.n < self.baseline_rows * max(proj.shape[-1], 1):
            self._base.add_batch(coords)
            return
        self._live_rows += proj.shape[0]
        m, v = float(coords.mean()), float(coords.var())
        a = self.ewma_alpha
        self._ewma_mean = m if self._ewma_mean is None else (
            (1 - a) * self._ewma_mean + a * m)
        self._ewma_var = v if self._ewma_var is None else (
            (1 - a) * self._ewma_var + a * v)

    # -- query-side signal ------------------------------------------------

    def observe_survivors(self, counts: np.ndarray, budget: int) -> None:
        """Feed per-query survivor counts from the radius-select kernel
        together with the T budget they were selected under."""
        counts = np.asarray(counts, np.float64).reshape(-1)
        if counts.size == 0 or budget <= 0:
            return
        frac = np.clip(counts / float(budget), 0.0, 1.0 - 1e-9)
        hist = np.bincount((frac * self.occupancy_bins).astype(np.int64),
                           minlength=self.occupancy_bins).astype(np.float64)
        if self._occ_base.sum() < self.baseline_rows:
            self._occ_base += hist
            return
        self._occ_live += hist
        self._occ_live_n += counts.size

    @staticmethod
    def _tv(p: np.ndarray, q: np.ndarray) -> float:
        sp, sq = p.sum(), q.sum()
        if sp == 0 or sq == 0:
            return 0.0
        return 0.5 * float(np.abs(p / sp - q / sq).sum())

    # -- reporting --------------------------------------------------------

    def report(self) -> DriftReport:
        base_std = math.sqrt(max(self._base.var, 1e-24))
        mean_shift = (abs(self._ewma_mean - self._base.mean) / base_std
                      if self._ewma_mean is not None and self._base.n else 0.0)
        var_ratio = (abs(math.log(max(self._ewma_var, 1e-24)
                                  / max(self._base.var, 1e-24)))
                     if self._ewma_var is not None and self._base.n else 0.0)
        tv = (self._tv(self._occ_base, self._occ_live)
              if self._occ_live_n >= self.occupancy_bins else 0.0)
        recal = (mean_shift > self.mean_tol or var_ratio > self.var_tol
                 or tv > self.tv_tol)
        return DriftReport(
            baseline_rows=self._base.n, live_rows=self._live_rows,
            mean_shift=mean_shift, var_ratio=var_ratio, occupancy_tv=tv,
            recalibrate=recal,
        )
