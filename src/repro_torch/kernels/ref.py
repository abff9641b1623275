"""Plain PyTorch versions of the port's kernels (the semantics contract).

Each function repeats the arithmetic of the TPU kernel it stands for,
so the CPU tests can hold it against the JAX kernel in interpret mode,
and ``chip_smoke.py`` can hold the CUDA kernel against it on the card:

  pairwise_sq_dist      ← repro/kernels/pairwise_dist.py (norm trick,
                          clamp at 0; difference form for gathered rows,
                          as repro/kernels/ref.py:26-30)
  project_dist          ← repro/kernels/project_dist.py (x @ A, then the
                          norm trick, as repro/kernels/ref.py:37-45)
  topk_smallest         ← repro/kernels/topk.py (a stable sort: the
                          contract of lax.top_k, repro/kernels/ref.py:69-75)
  radius_select_kernel  ← repro/kernels/select.py (rung ladder,
                          bisection, index-ordered compaction)
  radius_select_exact   ← no TPU kernel: the CUDA select's answer, the
                          first T by (value, index) in index order, with
                          radius_select_kernel's survivor count
  verify_topk           ← repro/kernels/verify.py (difference form, as
                          repro/kernels/ref.py:234-253)
  adc_dist              ← repro/kernels/adc.py (LUT sums over code slots,
                          in slot order)
  pair_join             ← repro/kernels/pair_join.py (the band-major
                          pruned self-join, as the numpy oracle
                          repro/kernels/ref.py:164-231 walks it)

``topk_smallest`` is also the stable sort that stands in for every
``lax.top_k`` outside a kernel: it keeps the lowest-index tie-break.
"""
from __future__ import annotations

import torch

__all__ = ["pairwise_sq_dist", "project_dist", "topk_smallest", "select_rungs",
           "radius_select_kernel", "radius_select_exact", "verify_topk", "adc_dist",
           "pair_join"]

_INF = float("inf")

# The select kernel's fixed shape (the TPU kernel's defaults,
# repro/kernels/select.py:181-183); csrc/select.cu hard-codes the same.
_SELECT_RUNGS = 16
_SELECT_ITERS = 14
_SELECT_C2 = 2.25

# The join's tile side (the TPU kernel's default block_n,
# repro/kernels/pair_join.py:222); csrc/pair_join.cu's kTile is the same.
PAIR_JOIN_TILE = 128


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


def project_dist(x: torch.Tensor, a: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Squared projected distances |x·a − qp|²: x (N, d), a (d, m), qp
    (B, m) → (B, N) float32, i.e. ``pairwise_sq_dist(qp, x @ a)``; the
    kernel's point is that x @ a never goes to device memory."""
    return pairwise_sq_dist(qp, x.to(torch.float32) @ a.to(torch.float32))


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of d (B, N), ascending, ties to the lowest
    index (+inf entries included; NaN sorts last).  Returns (values
    (B, k) float32, indices (B, k) int32)."""
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


def radius_select_exact(d: torch.Tensor, tau0: torch.Tensor, T: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA select's answer (csrc/select.cu), plainly, on any device.

    d (B, N) float32 (+inf is padding, NaN is never selected), tau0 (B,)
    seeds → (vals (B, T), idx (B, T) int32, count (B,) int32): each row's
    first T real entries by (value, index), −0 and +0 equal, in
    ascending index order, padded with (+inf, −1) where the row has fewer
    than T real entries; and ``radius_select_kernel``'s exact survivor
    count.  A stable sort of the values gives ``radius_select_kernel``
    followed by the trim's stable sort, whenever that buffer held the
    first T.
    """
    d = d.to(torch.float32)
    B, N = d.shape
    count = radius_select_kernel(d, tau0, T, T_pad=T)[2]
    real = d < _INF
    key = torch.where(real, d, _INF) + 0.0  # −0 as +0
    first = torch.sort(key, dim=1, stable=True).indices[:, :T]  # the reals first
    taken = torch.gather(real, 1, first)
    idx = torch.sort(torch.where(taken, first, N), dim=1).values  # N: past every index
    vals = torch.where(idx < N, torch.gather(d, 1, idx.clamp_max(N - 1)), _INF)
    return vals, torch.where(idx < N, idx, -1).to(torch.int32), count


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


def adc_dist(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Asymmetric distances from code slots and per-query tables.

    codes (N, S) shared by the batch, or per-query (B, N, S), values in
    [0, V); lut (B, S, V) float32.  Returns (B, N) float32 with
    out[b, n] = Σ_s lut[b, s, codes[..., n, s]], summed in slot order
    s = 0..S−1 from 0, the order the CUDA kernel adds in.
    """
    lut = lut.to(torch.float32)
    B, S, _ = lut.shape
    if codes.shape[-1] != S:
        raise ValueError(f"adc_dist: codes {tuple(codes.shape)} for lut {tuple(lut.shape)}")
    N = codes.shape[-2]
    out = torch.zeros((B, N), dtype=torch.float32, device=lut.device)
    for s in range(S):
        col = codes[..., s].to(torch.int64)  # (N,) or (B, N)
        out = out + torch.gather(lut[:, s, :], 1, col.expand(B, N))
    return out


def _pair_join_block(n: int) -> int:
    """The tile side of the join: PAIR_JOIN_TILE, but no more than n
    rounded up to 8 and no less than 8 (repro/kernels/ref.py:185)."""
    return max(min(PAIR_JOIN_TILE, n + (-n) % 8 if n else 8), 8)


def pair_join(x: torch.Tensor, key: torch.Tensor, k: int, *, thresh2: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k closest pairs of x's rows by the band-major pruned self-join.

    x (n, d) sorted ascending by key (n,).  Tiles (i, i + b) of bN rows
    are visited band by band; a tile is skipped when its key gap
    key[j·bN] − key[end of block i] is positive and its square exceeds
    thresh2 · ub², ub² being the k-th smallest pair d² seen so far.
    Unskipped tiles compute norm-trick float32 d², clamped at 0, for the
    pairs gj > gi.  The gap test runs on the host in double, as the
    numpy oracle does, from key copied to the host once.

    Returns (d² (k,) ascending float32, pi (k,) int32, pj (k,) int32,
    stats (3,) int64 = [pairs_verified, tiles_pruned, bands_joined]),
    on x's device; pi < pj are row positions in the sorted order, and
    slots past the real pair count are (+inf, −1, −1).  Ties go to the
    earliest pair in traversal order.  ``bands_joined`` counts the bands
    with at least one joined tile (the reference reports the first two).
    """
    x = x.to(torch.float32)
    key_h = key.detach().to("cpu", torch.float32).numpy()
    n = x.shape[0]
    dev = x.device
    bN = _pair_join_block(n)
    n_ti = max(-(-n // bN), 1)
    norms = (x * x).sum(1)
    thresh2 = float(thresh2)

    vals = torch.empty((0,), dtype=torch.float32, device=dev)  # traversal order
    pis = torch.empty((0,), dtype=torch.int64, device=dev)
    pjs = torch.empty((0,), dtype=torch.int64, device=dev)
    ub2 = _INF
    pairs_verified = tiles_pruned = bands_joined = 0
    for b in range(n_ti):
        joined = False
        for i in range(n_ti - b):
            j = i + b
            si, sj = i * bN, j * bN
            ei, ej = min(si + bN, n), min(sj + bN, n)
            gap = float(key_h[sj] - key_h[ei - 1])  # float32 difference
            if gap > 0.0 and gap * gap > thresh2 * ub2:
                tiles_pruned += 1
                continue
            joined = True
            d2 = torch.clamp_min(norms[si:ei, None] + norms[None, sj:ej]
                                 - 2.0 * (x[si:ei] @ x[sj:ej].T), 0.0)
            gi = torch.arange(si, ei, device=dev)[:, None].expand(d2.shape)
            gj = torch.arange(sj, ej, device=dev)[None, :].expand(d2.shape)
            sel = (gj > gi).reshape(-1)  # row-major: the tile's flatten order
            mi, mj = ei - si, ej - sj
            pairs_verified += mi * (mi - 1) // 2 if i == j else mi * mj
            vals = torch.cat([vals, d2.reshape(-1)[sel]])
            pis = torch.cat([pis, gi.reshape(-1)[sel]])
            pjs = torch.cat([pjs, gj.reshape(-1)[sel]])
            if vals.numel() > 4096 + k:  # keep the running pool bounded
                keep = torch.sort(torch.sort(vals, stable=True).indices[: 2 * k]).values
                vals, pis, pjs = vals[keep], pis[keep], pjs[keep]
            if vals.numel() >= k:
                ub2 = float(torch.kthvalue(vals.cpu(), k).values)
        bands_joined += joined
    order = torch.sort(vals, stable=True).indices[:k]
    m = order.numel()
    out_v = torch.full((k,), _INF, dtype=torch.float32, device=dev)
    out_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    out_j = torch.full((k,), -1, dtype=torch.int32, device=dev)
    out_v[:m] = vals[order]
    out_i[:m] = pis[order].to(torch.int32)
    out_j[:m] = pjs[order].to(torch.int32)
    stats = torch.tensor([pairs_verified, tiles_pruned, bands_joined],
                         dtype=torch.int64, device=dev)
    return out_v, out_i, out_j, stats
