"""Shadow ground-truth auditor: does the quality math hold on live traffic?
(The port of ``repro.obs.quality``.)

PM-LSH's headline claim is *accurate distance estimation* — Lemma 2's
χ² estimator with Lemma 3's tunable 1−2α confidence interval — and the
rest of the stack (Eq. 9 select seeds, Eq. 10 candidate budgets, the
quant rerank tiers) inherits its calibration from that model.  The
auditor checks the model against what the running system serves:

  * **deterministic sampling.**  ``sampled(query)`` hashes the query
    bytes (keyed blake2) against ``sample_fraction`` — the same query
    always makes the same decision, in this package and in the
    reference, so an audit is replayable offline.  No RNG state.
  * **shadow ground truth, off the hot path.**  A sampled query is
    *enqueued* with the answer it was served; ``audit()`` later runs
    the exact brute-force kNN over the live rows and scores the served
    answer against it.  The hot path pays one hash and one small copy.
    The brute force runs where the rows live: on the index's device,
    in float32, difference then norm, as the reference sums it; the
    rows move there at most once per ``audit()`` call (a flat index's
    are there already), never once per item.
  * **online quality estimates.**  Running recall@k, realized
    approximation ratio (served/exact distance, positionwise — the
    paper's Eq. 12 overall ratio), and **measured CI coverage**: the
    fraction of (query, true-neighbor) pairs whose projected distance
    falls inside Lemma 3's interval ``[r·√(χ²_{1−α}(m)),
    r·√(χ²_α(m))]``.  Under the χ²(m) model that fraction IS 1−2α;
    the gap to the nominal value is the calibration error.

Every estimate is published through the ``repro_torch.obs.metrics``
registry (gauges ``quality_recall`` / ``quality_ratio`` /
``quality_ci_coverage`` / ``quality_calibration_error``, counters
``quality_sampled_total`` / ``quality_audited_total``).

Accounting identity: ``audited == sampled − pending`` — every sampled
query is either scored or still in the queue, never silently dropped
(a full queue refuses the *sample*, so the identity survives overload).

Usage::

    auditor = QualityAuditor.for_index(index, sample_fraction=0.05)
    res = index.search(q[None], k=10)
    auditor.maybe_sample(q, res.indices[0], res.distances[0])
    auditor.audit()                  # brute-force scoring, off-path
    rep = auditor.report()           # recall / ratio / coverage / alarm
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import struct
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..device import as_tensor, resolve_device

__all__ = ["QualityAuditor", "QualityReport", "ci_coverage",
           "sample_decision"]


def sample_decision(query_bytes: bytes, fraction: float,
                    seed: int = 0) -> bool:
    """Deterministic, replayable coin flip: keyed-hash the query bytes
    into [0, 1) and compare against ``fraction``.  The same (query,
    seed) always lands the same side, independent of call order."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    h = hashlib.blake2b(query_bytes, digest_size=8,
                        key=struct.pack("<q", seed)).digest()
    return int.from_bytes(h, "little") < fraction * 2.0 ** 64


def ci_coverage(exact_dists: np.ndarray, projected_dists: np.ndarray,
                m: int, alpha: float) -> tuple[int, int]:
    """Lemma 3 coverage count: of the (query, neighbor) pairs with true
    distance r > 0, how many projected distances r' landed inside
    ``[r·√(χ²_{1−α}(m)), r·√(χ²_α(m))]``?  Returns (inside, total).
    Under the Lemma-1 model r'²/r² ~ χ²(m), so inside/total → 1−2α."""
    from ..core.estimator import chi2_upper_quantile

    r = np.asarray(exact_dists, np.float64).reshape(-1)
    rp = np.asarray(projected_dists, np.float64).reshape(-1)
    ok = r > 0
    r, rp = r[ok], rp[ok]
    if r.size == 0:
        return 0, 0
    lo = np.sqrt(chi2_upper_quantile(1.0 - alpha, m))
    hi = np.sqrt(chi2_upper_quantile(alpha, m))
    ratio = rp / r
    inside = int(np.sum((ratio >= lo) & (ratio <= hi)))
    return inside, int(r.size)


@dataclasses.dataclass(frozen=True)
class QualityReport:
    """Frozen view of the auditor's online estimates."""

    sampled: int  # queries the hash admitted
    audited: int  # queries scored against brute force
    pending: int  # sampled, not yet scored (in-flight)
    recall: float  # mean recall@k over audited queries
    ratio: float  # mean realized approximation ratio (Eq. 12 form)
    ci_coverage: float  # measured Lemma-3 coverage over neighbor pairs
    nominal_coverage: float  # 1 − 2α from PMLSHParams
    coverage_pairs: int  # (query, neighbor) pairs behind ci_coverage
    alpha: float

    @property
    def calibration_error(self) -> float:
        """Nominal − measured coverage: positive = the live data is
        UNDER-covered vs the χ²(m) model (recalibration signal)."""
        return self.nominal_coverage - self.ci_coverage

    def alarming(self, tolerance: float = 0.05, min_pairs: int = 50) -> bool:
        """True when measured coverage trails nominal by more than
        ``tolerance`` with at least ``min_pairs`` pairs observed."""
        return (self.coverage_pairs >= min_pairs
                and self.calibration_error > tolerance)


class QualityAuditor:
    """Online recall / ratio / CI-coverage auditing over live queries.

    Args:
      get_rows: callable returning ``(ids (n,) int64, rows (n, d))`` —
        the CURRENT live datastore (called at audit time, so mutations
        between sampling and auditing score against fresh truth); rows
        a tensor (used where it lies) or a host array (moved to
        ``device`` once per ``audit()``).
      family: projection family (``project(q)``) for the coverage
        audit; None disables coverage (recall/ratio still run).
      m / alpha: the χ² model order and CI tail mass (typically
        ``params.m`` / ``params.alpha1`` from the build-time Eq. 10
        solve — nominal coverage is 1 − 2α).
      sample_fraction / seed: the deterministic hash sampler's knobs.
      max_pending: audit-queue bound; a full queue REFUSES new samples
        (counted in ``overflowed``) so the shadow copy of an overloaded
        server stays bounded.
      registry: metrics registry to publish through (default global).
      device: where host rows are scored (default the card).
    """

    def __init__(self, get_rows: Callable[[], tuple], *, family=None,
                 m: int = 15, alpha: float | None = None,
                 sample_fraction: float = 0.01, seed: int = 0,
                 max_pending: int = 256, registry=None,
                 device: str | torch.device = "cuda"):
        from . import metrics as _metrics

        self.get_rows = get_rows
        self.family = family
        self.device = resolve_device(device)
        self.m = int(m)
        self.alpha = float(alpha if alpha is not None else 1.0 / math.e)
        self.sample_fraction = float(sample_fraction)
        self.seed = int(seed)
        self.max_pending = int(max_pending)
        self._pending: deque = deque()
        self.sampled = 0
        self.audited = 0
        self.overflowed = 0  # samples refused by a full queue
        self._recall_sum = 0.0
        self._ratio_sum = 0.0
        self._ratio_n = 0
        self._cov_inside = 0
        self._cov_total = 0
        reg = registry if registry is not None else _metrics.get_registry()
        self._g_recall = reg.gauge("quality_recall",
                                   "audited recall@k (running mean)")
        self._g_ratio = reg.gauge(
            "quality_ratio", "realized approximation ratio (running mean)")
        self._g_cov = reg.gauge("quality_ci_coverage",
                                "measured Lemma-3 CI coverage")
        self._g_cal = reg.gauge(
            "quality_calibration_error",
            "nominal (1-2a) minus measured CI coverage")
        self._c_sampled = reg.counter("quality_sampled_total",
                                      "queries admitted by the hash sampler")
        self._c_audited = reg.counter("quality_audited_total",
                                      "queries scored against brute force")
        self._g_cal.set(0.0)
        self._g_cov.set(self.nominal_coverage)

    @classmethod
    def for_index(cls, index, *, sample_fraction: float = 0.01,
                  seed: int = 0, alpha: float | None = None, **kw
                  ) -> "QualityAuditor":
        """Build an auditor wired to a facade backend of the port
        (``flat``, ``flat-pq``, ``pmtree``, ``streaming``): live rows
        from the index (streaming ``live_ids``/``get_vectors``, a flat
        index's rows on its device, a pmtree's host ``data``), the
        projection family and χ² order from the build-time config (the
        streaming index's own A), α from the cached Eq. 10 solve, and
        the index's device."""
        from ..core.estimator import solve_parameters
        from ..core.hashing import ProjectionFamily

        cfg = getattr(index, "config", None)
        device = resolve_device(kw.pop("device", getattr(index, "device", "cuda")))
        impl = getattr(index, "impl", None)
        family = getattr(impl, "family", None)
        params = getattr(impl, "params", None)
        if params is None and cfg is not None:
            params = solve_parameters(cfg.c, m=cfg.m)
        m = params.m if params is not None else getattr(cfg, "m", 15)
        if family is None and getattr(index, "_a", None) is not None:
            family = ProjectionFamily.from_numpy(index._a, device)
        elif family is None and cfg is not None:
            family = ProjectionFamily.from_seed(index.d, m, cfg.seed, device)

        def get_rows():
            live_ids = getattr(index, "live_ids", None)
            get_vectors = getattr(index, "get_vectors", None)
            if callable(live_ids) and callable(get_vectors):
                ids = np.asarray(live_ids(), np.int64)
                return ids, get_vectors(ids)
            rows = getattr(impl, "data", None)
            if not isinstance(rows, torch.Tensor):
                rows = index.data
            return np.arange(rows.shape[0], dtype=np.int64), rows

        if alpha is None and params is not None:
            alpha = params.alpha1
        return cls(get_rows, family=family, m=m, alpha=alpha,
                   sample_fraction=sample_fraction, seed=seed, device=device,
                   **kw)

    @property
    def nominal_coverage(self) -> float:
        return 1.0 - 2.0 * self.alpha

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- hot path ---------------------------------------------------------

    def sampled_query(self, query: np.ndarray) -> bool:
        """The deterministic sampling decision alone (replayable)."""
        q = np.ascontiguousarray(query, np.float32)
        return sample_decision(q.tobytes(), self.sample_fraction, self.seed)

    def maybe_sample(self, query, indices, distances) -> bool:
        """Hash-sample one served answer into the audit queue.

        ``indices`` / ``distances`` are the (k,) served answer row
        (global ids, original-space distances).  Returns True when the
        query was enqueued.  Cost on the miss path: one hash."""
        q = np.ascontiguousarray(np.asarray(query, np.float32).reshape(-1))
        if not sample_decision(q.tobytes(), self.sample_fraction, self.seed):
            return False
        if len(self._pending) >= self.max_pending:
            self.overflowed += 1
            return False
        self.sampled += 1
        self._c_sampled.inc()
        self._pending.append((q.copy(),
                              np.asarray(indices, np.int64).reshape(-1).copy(),
                              np.asarray(distances,
                                         np.float32).reshape(-1).copy()))
        return True

    # -- off the hot path -------------------------------------------------

    def audit(self, max_items: int | None = None) -> int:
        """Score up to ``max_items`` pending samples against exact
        brute-force kNN over the current live rows; returns how many
        were audited.  Call from idle time or at end-of-trace."""
        if not self._pending:
            return 0
        ids, rows = self.get_rows()
        ids = np.asarray(ids, np.int64).reshape(-1)
        if isinstance(rows, torch.Tensor):
            rows = rows.to(torch.float32)
        else:
            rows = as_tensor(rows, self.device)
        done = 0
        proj_rows = None
        while self._pending and (max_items is None or done < max_items):
            q, served_ids, served_dd = self._pending.popleft()
            done += 1
            self.audited += 1
            self._c_audited.inc()
            if rows.shape[0] == 0:
                continue
            k = int(np.sum(served_ids >= 0)) or served_ids.size
            k = min(k, rows.shape[0])
            qt = torch.from_numpy(q).to(rows.device)
            dd = torch.linalg.vector_norm(rows - qt[None], dim=-1)
            vals, part = torch.topk(dd, k, largest=False)
            order = part[torch.sort(vals, stable=True).indices]
            order_h = order.cpu().numpy()
            exact_ids = ids[order_h]
            exact_dd = dd[order].cpu().numpy()
            got = set(int(i) for i in served_ids if i >= 0)
            self._recall_sum += len(got & set(int(i) for i in exact_ids)) / k
            # realized ratio, positionwise over the valid served prefix
            sv = np.sort(served_dd[np.isfinite(served_dd)])[:k]
            if sv.size:
                ex = exact_dd[: sv.size]
                self._ratio_sum += float(
                    np.mean(sv / np.maximum(ex, 1e-12)))
                self._ratio_n += 1
            if self.family is not None:
                a_dev = self.family.a.device
                if proj_rows is None:
                    proj_rows = self.family.project(rows.to(a_dev))
                qp = self.family.project(qt.to(a_dev)[None])[0]
                rp = torch.linalg.vector_norm(
                    proj_rows[order.to(a_dev)] - qp[None], dim=-1)
                inside, total = ci_coverage(exact_dd, rp.cpu().numpy(),
                                            self.m, self.alpha)
                self._cov_inside += inside
                self._cov_total += total
        self._publish()
        return done

    def _publish(self) -> None:
        rep = self.report()
        self._g_recall.set(rep.recall)
        self._g_ratio.set(rep.ratio)
        self._g_cov.set(rep.ci_coverage)
        self._g_cal.set(rep.calibration_error)

    def report(self) -> QualityReport:
        audited = max(self.audited, 1)
        cov = (self._cov_inside / self._cov_total if self._cov_total
               else self.nominal_coverage)
        return QualityReport(
            sampled=self.sampled, audited=self.audited,
            pending=len(self._pending),
            recall=self._recall_sum / audited,
            ratio=self._ratio_sum / max(self._ratio_n, 1),
            ci_coverage=cov, nominal_coverage=self.nominal_coverage,
            coverage_pairs=self._cov_total, alpha=self.alpha,
        )
