"""Plain PM-LSH, the yardstick the benchmark holds the program to.

Written from the paper (Zheng et al., PVLDB 13(5), 2020) in plain PyTorch
and nothing else: no kernel, no cache, no batching trick.  It takes only
what the benchmark made (rows, queries, the projection A) and works out
again everything the program derives from them: the Eq. 10 parameters,
the candidate budget T = beta*n + k, the projected estimates, the
candidate sets, the exact distances and the answers.

``precision="f64"`` is the reference: every distance in float64.
``precision="tf32"`` is the control, the nearest precision below the
float32 that the configurations state: every matrix product takes its
operands rounded to TF32 (10 mantissa bits) and sums in float32, the way
a TF32 tensor-core product does, and distances come from the product
form |q|^2 + |x|^2 - 2 q.x.  The rounding is done by hand, so the control
reads the same on the CPU and on the card.
"""
from __future__ import annotations

import math

import torch
from scipy.stats import chi2

__all__ = ["solve", "budget", "projection_from_seed", "to_tf32", "AnnReference",
           "CpReference"]

F64 = torch.float64
PRECISIONS = ("f64", "tf32")


def solve(c: float, m: int, alpha1: float = 1.0 / math.e) -> tuple[float, float]:
    """Eq. 10 at (c, m, alpha1) with beta = 2 alpha2 (Lemma 5): (beta, t).

    t^2 is the upper alpha1-quantile of chi^2(m); alpha2 is the chance that
    a point c times farther falls inside the projected ball, CDF(t^2/c^2).
    """
    t2 = float(chi2.ppf(1.0 - alpha1, m))
    alpha2 = float(chi2.cdf(t2 / (c * c), m))
    return 2.0 * alpha2, math.sqrt(t2)


def budget(beta: float, n: int, k: int) -> int:
    """T = ceil(beta n) + k candidates, within [k, n]."""
    return int(min(max(math.ceil(beta * n) + k, k), n))


def projection_from_seed(d: int, m: int, seed: int) -> torch.Tensor:
    """A ~ N(0, 1)^(d, m) drawn from a CPU generator seeded with ``seed``:
    the draw an index makes from ``IndexConfig.seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((d, m), generator=gen, dtype=torch.float32)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _product(x: torch.Tensor, y: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ y in the given precision."""
    if precision == "f64":
        return x.to(F64) @ y.to(F64)
    return to_tf32(x) @ to_tf32(y)


def _sq_dist(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) squared distances.  float64 sums the
    product form exactly enough for these data; the control sums it in
    float32 over TF32 operands."""
    if precision == "f64":
        q, x = q.to(F64), x.to(F64)
        return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                - 2.0 * (q @ x.T)).clamp_min(0.0)
    qn = (q.to(torch.float32) ** 2).sum(1)[:, None]
    xn = (x.to(torch.float32) ** 2).sum(1)[None, :]
    return (qn + xn - 2.0 * _product(q, x.T, precision)).clamp_min(0.0)


class AnnReference:
    """(c, k)-ANN by the flat PM-LSH pipeline of the paper's Lemmas 1-4:
    project, estimate, keep the T candidates of smallest estimate (ties to
    the lower id), verify them exactly, answer the k nearest."""

    def __init__(self, rows: torch.Tensor, a: torch.Tensor, *, c: float = 1.5,
                 precision: str = "f64", query_block: int = 8):
        _check_precision(precision)
        self.rows = rows
        self.a = a.to(rows.device)
        self.precision = precision
        self.query_block = int(query_block)
        self.n, self.d = rows.shape
        self.m = self.a.shape[1]
        self.beta, self.t = solve(c, self.m)
        self.projected = _product(rows, self.a, precision)  # (n, m)

    def budget(self, k: int) -> int:
        return budget(self.beta, self.n, k)

    def estimates(self, q: torch.Tensor) -> torch.Tensor:
        """(B, n) projected squared distances."""
        qp = _product(q.to(self.rows.device), self.a, self.precision)
        return _sq_dist(qp, self.projected, self.precision)

    def candidates(self, q: torch.Tensor, T: int) -> torch.Tensor:
        """(B, T) int64 ids of the T smallest estimates of each query."""
        est = self.estimates(q)
        return torch.sort(est, dim=1, stable=True).indices[:, :T]

    def verify(self, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        """(B, T) squared distances of each query to its candidates: the
        difference form in float64, the product form in the control."""
        q = q.to(self.rows.device)
        out = []
        for s in range(0, q.shape[0], self.query_block):
            qb, cb = q[s:s + self.query_block], cand[s:s + self.query_block]
            rows = self.rows[cb]  # (b, T, d)
            if self.precision == "f64":
                diff = rows.to(F64) - qb.to(F64)[:, None, :]
                out.append((diff * diff).sum(-1))
            else:
                qn = (qb.to(torch.float32) ** 2).sum(1)[:, None]
                xn = (rows.to(torch.float32) ** 2).sum(-1)
                dot = torch.bmm(to_tf32(rows), to_tf32(qb)[:, :, None])[..., 0]
                out.append((qn + xn - 2.0 * dot).clamp_min(0.0))
        return torch.cat(out)

    def answer(self, q: torch.Tensor, k: int, T: int | None = None):
        """(ids (B, k) int64, distances (B, k)) for queries q (B, d)."""
        T = self.budget(k) if T is None else int(T)
        cand = self.candidates(q, T)
        d2 = self.verify(q, cand)
        order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        return torch.gather(cand, 1, order), torch.gather(d2, 1, order).sqrt()

    def distances(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """float64 distances of queries q (B, d) to rows ids (B, k)."""
        q = q.to(self.rows.device, F64)
        rows = self.rows[ids.to(self.rows.device).long().clamp(0, self.n - 1)].to(F64)
        return ((rows - q[:, None, :]) ** 2).sum(-1).sqrt()


class CpReference:
    """(c, k)-ACP: the k nearest pairs of the rows, exactly, by which a
    closest-pair answer's approximation ratio is read; and the paper's
    Algorithm 4 filter, under which points are keyed by one 2-stable
    projection and a pair whose key gap exceeds gamma * t * D (D the k-th
    answer distance) may be skipped."""

    def __init__(self, rows: torch.Tensor, a0: torch.Tensor, *, c: float = 4.0,
                 m: int = 15, gamma: float = 1.0, precision: str = "f64",
                 row_block: int = 2048):
        _check_precision(precision)
        self.rows = rows
        self.precision = precision
        self.row_block = int(row_block)
        self.n, self.d = rows.shape
        _, t = solve(c, m)
        self.reach = float(gamma * t)  # key gaps past reach * D may be skipped
        a0 = a0.to(rows.device).reshape(-1, 1)
        self.key = _product(rows, a0, precision)[:, 0]

    def distances(self, pairs: torch.Tensor) -> torch.Tensor:
        """float64 distances of (P, 2) row pairs, in the difference form."""
        pairs = pairs.to(self.rows.device).long()
        diff = self.rows[pairs[:, 0]].to(F64) - self.rows[pairs[:, 1]].to(F64)
        return (diff * diff).sum(1).sqrt()

    def nearest(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The k nearest pairs (i < j), ascending: ((k, 2) int64, (k,)),
        ranked in this reference's precision; float64 distances in the
        difference form, the control's in its own product form."""
        k = min(int(k), self.n * (self.n - 1) // 2)
        best_d, best_p = [], []
        for s in range(0, self.n, self.row_block):
            xb = self.rows[s:s + self.row_block]
            d2 = _sq_dist(xb, self.rows, self.precision)
            ii = torch.arange(s, s + xb.shape[0], device=d2.device)[:, None]
            jj = torch.arange(self.n, device=d2.device)[None, :]
            d2 = torch.where(jj > ii, d2, torch.full_like(d2, float("inf")))
            v, flat = torch.topk(d2.reshape(-1), min(k, d2.numel()), largest=False)
            best_d.append(v)
            best_p.append(torch.stack([flat // self.n + s, flat % self.n], 1))
        d2 = torch.cat(best_d)
        pairs = torch.cat(best_p)
        keep = torch.isfinite(d2)
        pairs, d2 = pairs[keep], d2[keep]
        if self.precision == "f64":
            dist = self.distances(pairs)
        else:
            dist = d2.to(torch.float32).sqrt()
        pairs, dist = _sorted_pairs(pairs, dist)
        return pairs[:k], dist[:k]

    def filter_pairs(self, D: float) -> int:
        """How many pairs the Algorithm 4 filter must verify at k-th
        distance D: those whose key gap is at most gamma * t * D."""
        keys = torch.sort(self.key.to(F64)).values
        ends = torch.searchsorted(keys, keys + self.reach * float(D), right=True)
        return int((ends - torch.arange(1, keys.numel() + 1, device=keys.device)).sum())


def _sorted_pairs(pairs: torch.Tensor, dist: torch.Tensor):
    """Pairs ascending by distance, then by (i, j)."""
    if pairs.shape[0] == 0:
        return pairs, dist
    n = int(pairs.max()) + 1
    order = torch.sort(pairs[:, 0] * n + pairs[:, 1], stable=True).indices
    pairs, dist = pairs[order], dist[order]
    order = torch.sort(dist, stable=True).indices
    return pairs[order], dist[order]
