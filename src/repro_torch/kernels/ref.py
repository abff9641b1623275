"""Plain PyTorch versions of the port's kernels (the semantics contract).

Each function repeats the arithmetic of the TPU kernel it stands for,
so the CPU tests can hold it against the JAX kernel in interpret mode,
and ``chip_smoke.py`` can hold the CUDA kernel against it on the card:

  pairwise_sq_dist      ← repro/kernels/pairwise_dist.py (norm trick,
                          clamp at 0; difference form for gathered rows,
                          as repro/kernels/ref.py:26-30)
  radius_select_kernel  ← repro/kernels/select.py (rung ladder,
                          bisection, index-ordered compaction)
  verify_topk           ← repro/kernels/verify.py (difference form, as
                          repro/kernels/ref.py:234-253)

``topk_smallest`` is the stable sort that stands in for every
``lax.top_k`` outside a kernel: it keeps the lowest-index tie-break.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sq_dist", "topk_smallest", "select_rungs",
           "radius_select_kernel", "verify_topk"]

_INF = float("inf")

# The select kernel's fixed shape (the TPU kernel's defaults,
# repro/kernels/select.py:181-183); csrc/select.cu hard-codes the same.
_SELECT_RUNGS = 16
_SELECT_ITERS = 14
_SELECT_C2 = 2.25


def pairwise_sq_dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of q (B, d) and x (N, d),
    or per-query rows x (B, N, d).  Returns (B, N) float32.

    The 2-D form is the TPU kernel's (|q|² + |x|²) − 2·q·xᵀ clamped at
    0; the gathered per-query form sums (x − q)² directly, which avoids
    the norm trick's cancellation on near-duplicates.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if x.ndim == 3:
        return ((x - q[:, None, :]) ** 2).sum(-1)
    qn = (q * q).sum(1, keepdim=True)
    xn = (x * x).sum(1)
    return torch.clamp_min(qn + xn[None, :] - 2.0 * (q @ x.T), 0.0)


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of d (B, N), ascending, ties to the lowest
    index.  Returns (values (B, k) float32, indices (B, k) int32)."""
    vals, idx = torch.sort(d.to(torch.float32), dim=1, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def select_rungs() -> torch.Tensor:
    """(16,) float32 rung factors 2.25^(l − 8), each computed in double and
    rounded once.  The TPU kernel's ladder thresholds are τ0 times these
    (select.py:81), and XLA's float32 pow gives the same values at the
    integer exponents of its bracket (select.py:101-105)."""
    L0 = _SELECT_RUNGS // 2
    return torch.tensor([_SELECT_C2 ** (l - L0) for l in range(_SELECT_RUNGS)],
                        dtype=torch.float32)


def radius_select_kernel(d: torch.Tensor, tau0: torch.Tensor, T: int, *,
                         T_pad: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The select kernel's algorithm, step by step, on any device.

    d (B, N) float32 (+inf is padding), tau0 (B,) seeds → (vals (B, T_pad),
    idx (B, T_pad) int32, count (B,) int32): the survivors d ≤ hi in
    ascending index order, padded with (+inf, −1), and the exact
    survivor count.  count > T_pad means the buffer overflowed and holds
    only the first T_pad survivors by index.
    """
    d = d.to(torch.float32)
    B, N = d.shape
    if not 1 <= T <= N:
        raise ValueError(f"radius_select: T={T} out of range for N={N}")
    if T_pad < T:
        raise ValueError(f"radius_select: T_pad={T_pad} < T={T}")
    L = _SELECT_RUNGS
    rungs = select_rungs().to(d.device)
    tau0 = torch.clamp_min(tau0.to(torch.float32), 1e-30)
    real = d < _INF

    # phase 0: survivors of every rung, and the data max (select.py:79-90)
    thr = tau0[:, None] * rungs[None, :]  # (B, L)
    lad = torch.stack([((d <= thr[:, l:l + 1]) & real).sum(1)
                       for l in range(L)], dim=1)
    dmax = torch.clamp_min(torch.where(real, d, -_INF).amax(1), 0.0)
    ge = lad >= T
    any_ge = ge.any(1)
    first = ge.to(torch.int32).argmax(1)
    hi = torch.where(any_ge, tau0 * rungs[first], dmax)
    hi = torch.minimum(hi, dmax)
    lo = torch.where(any_ge & (first > 0),
                     tau0 * rungs[torch.clamp_min(first - 1, 0)],
                     torch.zeros_like(hi))
    lo = torch.where(any_ge, lo, tau0 * rungs[L - 1])
    lo = torch.minimum(lo, hi)

    # phases 1..iters: bisection on the bracket (select.py:114-126)
    for _ in range(_SELECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = ((d <= mid[:, None]) & real).sum(1) >= T
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)

    # last phase: compaction in ascending index order (select.py:137-166)
    mask = (d <= hi[:, None]) & real
    count = mask.sum(1).to(torch.int32)
    rank = torch.cumsum(mask, dim=1) - 1
    rows, cols = torch.nonzero(mask & (rank < T_pad), as_tuple=True)
    slots = rank[rows, cols]
    vals = torch.full((B, T_pad), _INF, dtype=torch.float32, device=d.device)
    idx = torch.full((B, T_pad), -1, dtype=torch.int32, device=d.device)
    vals[rows, slots] = d[rows, cols]
    idx[rows, slots] = cols.to(torch.int32)
    return vals, idx, count


def verify_topk(data: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-verify candidates and answer.

    data (n, d) × q (B, d) × cand (B, Tc) ids (−1 = padding) → (d² (B, k)
    ascending, ids (B, k) int32); ties go to the earliest candidate
    position and slots past a row's real candidates are (+inf, −1).
    Materializes the gathered (B, Tc, d) rows the kernel avoids.
    """
    cand = cand.to(torch.int64)
    rows = data.to(torch.float32)[torch.clamp_min(cand, 0)]  # (B, Tc, d)
    d2 = pairwise_sq_dist(q, rows)
    d2 = torch.where(cand < 0, _INF, d2)
    if k > cand.shape[1]:  # short candidate rows keep the (B, k) contract
        pad = k - cand.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=_INF)
        cand = torch.nn.functional.pad(cand, (0, pad), value=-1)
    vals, sel = topk_smallest(d2, k)
    ids = torch.gather(cand, 1, sel.to(torch.int64))
    ids = torch.where(torch.isinf(vals), -1, ids)
    return vals, ids.to(torch.int32)
