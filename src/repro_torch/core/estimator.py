"""The parameter solver of PM-LSH (paper §3.2, §4.3).

Lemma 1/2: ``r'^2 / r^2 ~ χ²(m)``, so χ² quantiles bound the projected
distance of a point at distance r.

* Eq. 10 — the parameter solver: given approximation ratio ``c``, number
  of hash functions ``m`` and failure probability ``α₁``, produce
  ``t`` (projected-radius multiplier), ``α₂`` and ``β`` such that
  E1 holds w.p. ≥ 1-α₁ and E2 w.p. ≥ 1-α₂/β (Lemma 4), giving the
  Theorem-1 c²-ANN success probability ≥ 1/2 - 1/e at the default
  setting (α₁ = 1/e, β = 2α₂).
* ``select_rmin`` — the r_min selection scheme of §5.2: the smallest
  radius whose ball is expected to hold βn + k points, from the
  empirical distance distribution F(x) (Eq. 4).

All functions here are *host-side* (numpy/scipy); their outputs are
plain floats fixed before any query runs, mirroring how the paper fixes
parameters offline.  This module copies what the port needs of
``repro.core.estimator``: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.stats import chi2 as _chi2


def chi2_ppf(p: float, m: int) -> float:
    return float(_chi2.ppf(p, m))


def chi2_cdf(x: float, m: int) -> float:
    return float(_chi2.cdf(x, m))


def chi2_upper_quantile(alpha: float, m: int) -> float:
    """χ²_α(m): the UPPER quantile, ∫_{χ²_α}^∞ f = α (paper's convention)."""
    return chi2_ppf(1.0 - alpha, m)


@dataclasses.dataclass(frozen=True)
class PMLSHParams:
    """Solved query parameters (Eq. 10 + Lemma 5 defaults).

    Attributes:
      m:      number of hash functions (projected dimensionality).
      c:      approximation ratio (> 1).
      alpha1: Pr[a true-positive escapes the projected ball]  (E1 failure).
      alpha2: expected fraction of far points inside the projected ball.
      beta:   candidate budget fraction; examine βn + k candidates.
      t:      projected radius multiplier — range query uses radius t·r.
    """

    m: int
    c: float
    alpha1: float
    alpha2: float
    beta: float
    t: float

    @property
    def success_probability(self) -> float:
        """Lower bound on joint Pr[E1 ∧ E2] = 1 - α₁ - α₂/β (Lemma 4/5)."""
        return 1.0 - self.alpha1 - self.alpha2 / self.beta


def solve_parameters(
    c: float, m: int = 15, alpha1: float = 1.0 / math.e, beta: float | None = None
) -> PMLSHParams:
    """Solve Eq. 10 for (t, α₂) given (c, m, α₁); default β = 2α₂ (Lemma 5).

      t² = χ²_{α₁}(m)          (E1: true positives stay inside t·r)
      t² = c² χ²_{1-α₂}(m)  ⇒  α₂ = CDF_{χ²(m)}(t²/c²)

    (χ²_{1-α₂} is the upper (1-α₂)-quantile, i.e. the LOWER α₂ tail:
    a far point (r_o > c·r) falls inside the projected ball t·r with
    probability Pr[χ² < t²/c²] = α₂ — Lemma 3/P1 with α = α₂.)

    Note: the paper reports α₂ = 0.1405, β = 0.2809 for (c=1.5, m=15,
    α₁=1/e), which corresponds to t ≈ 4.58 rather than the
    √(χ²_{1/e}(15)) = 4.03 that Eq. 10 yields; solving Eq. 10 exactly
    gives the *stricter* α₂ ≈ 0.048, β ≈ 0.097 (fewer candidates, same
    Lemma-5 guarantee since Pr[E2] ≥ 1 - α₂/β = 1/2 either way).  We
    keep the exact solve as the default and expose `beta` so benchmarks
    can also reproduce the paper's published operating point.
    """
    if not c > 1.0:
        raise ValueError(f"approximation ratio c must exceed 1, got {c}")
    if m < 1:
        raise ValueError("m must be >= 1")
    if not 0.0 < alpha1 < 1.0:
        raise ValueError("alpha1 must be in (0,1)")
    t2 = chi2_upper_quantile(alpha1, m)
    t = math.sqrt(t2)
    alpha2 = chi2_cdf(t2 / (c * c), m)
    if beta is None:
        beta = 2.0 * alpha2
    return PMLSHParams(m=m, c=float(c), alpha1=float(alpha1), alpha2=float(alpha2),
                       beta=float(beta), t=float(t))


def empirical_distance_distribution(
    points: np.ndarray, n_samples: int = 100_000, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Estimate F(x) of Eq. 4 by sampling point pairs.

    Returns (sorted_distances, cdf_values); evaluate F via np.searchsorted.
    """
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    i = rng.integers(0, n, size=n_samples)
    j = rng.integers(0, n, size=n_samples)
    keep = i != j
    i, j = i[keep], j[keep]
    d = np.linalg.norm(points[i] - points[j], axis=-1)
    d.sort()
    cdf = np.arange(1, d.size + 1, dtype=np.float64) / d.size
    return d, cdf


def select_rmin(
    points: np.ndarray,
    beta: float,
    k: int,
    *,
    shrink: float = 0.9,
    n_samples: int = 50_000,
    seed: int = 0,
) -> float:
    """§5.2 r_min selection: r s.t. n·F(r) ≈ βn + k, shrunk slightly so the
    first range query does not over-collect."""
    n = points.shape[0]
    d, cdf = empirical_distance_distribution(points, n_samples=n_samples, seed=seed)
    target = min((beta * n + k) / n, 1.0)
    idx = int(np.searchsorted(cdf, target))
    idx = min(max(idx, 0), d.size - 1)
    r = float(d[idx]) * shrink
    return max(r, float(d[0]) * 0.5, 1e-12)
