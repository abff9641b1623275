"""Dispatch over the port's kernels, mirroring ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version in ``ref``.  ``force="plain"`` takes the plain
version on any device: it exists for the tests and for ``chip_smoke.py``,
which holds each kernel against it on the card.  There is no interpret
mode and no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from . import adc as _adc
from . import counts, ref
from . import pair_join as _pair_join
from . import pairwise_dist as _pairwise
from . import project_dist as _project
from . import select as _select
from . import topk as _topk
from . import verify as _verify

__all__ = ["pairwise_sq_dist", "project_dist", "topk_smallest",
           "default_select_seed", "radius_select", "verify_topk", "adc_dist",
           "pair_join"]


def _plain(force: str | None, *tensors: torch.Tensor) -> bool:
    """True where the plain version answers: forced, or CPU tensors."""
    if force not in (None, "plain"):
        raise ValueError(f"force must be None or 'plain', got {force!r}")
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: {sorted(kinds)}")
    return force == "plain" or kinds == {"cpu"}


def pairwise_sq_dist(q: torch.Tensor, x: torch.Tensor, *,
                     force: str | None = None) -> torch.Tensor:
    """(B,d) × (N,d) → (B,N) squared Euclidean distances (float32).

    x may be per-query candidate rows (B, N, d), the gathered VERIFY
    form, which sums in the difference form.
    """
    if _plain(force, q, x):
        return ref.pairwise_sq_dist(q, x)
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    if x.ndim == 3:
        return _pairwise.pairwise_sq_dist_rows(q, x)
    return _pairwise.pairwise_sq_dist(q, x)


def project_dist(x: torch.Tensor, a: torch.Tensor, qp: torch.Tensor, *,
                 force: str | None = None) -> torch.Tensor:
    """Fused (x @ a) projected distances to qp: (N, d), (d, m), (B, m) →
    (B, N) squared distances, the projection never written out."""
    if _plain(force, x, a, qp):
        return ref.project_dist(x, a, qp)
    return _project.project_dist(x.to(torch.float32).contiguous(),
                                 a.to(torch.float32).contiguous(),
                                 qp.to(torch.float32).contiguous())


def topk_smallest(d: torch.Tensor, k: int, *, force: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest (values, indices int32) of d (B, N), ascending,
    ties to the lowest index.

    k > 128 is past the kernel's width and answers through
    ``radius_select``, on any device, as the reference routes it
    (ops.py:180-181).
    """
    N = d.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"topk_smallest: k={k} out of range for N={N}")
    if k > _topk.MAX_K:
        counts.route("topk_smallest.k_over_128")
        return radius_select(d, k, force=force)
    if _plain(force, d):
        return ref.topk_smallest(d, k)
    return _topk.topk_smallest(d.to(torch.float32).contiguous(), k)


def default_select_seed(d: torch.Tensor, T: int, *, stride: int = 8) -> torch.Tensor:
    """Per-row seed for radius selection from a strided sample of d:
    the sample mean scaled by the target fraction T/N — within the
    rung ladder's reach of the T-th smallest for any unimodal row."""
    samp = d[:, ::stride]
    N = d.shape[1]
    return samp.mean(1) * max(T / N, 1e-3)


def radius_select(d: torch.Tensor, T: int, *, tau0: torch.Tensor | None = None,
                  T_pad: int | None = None, force: str | None = None,
                  with_count: bool = False):
    """Row-wise T smallest (values, indices) by radius thresholding.

    Ascending, lowest-index tie-break, like a stable sort.  The kernel
    compacts the survivors of a threshold into T_pad ≥ T slots and one
    stable sort over those finishes.  A tie cluster wider than the
    buffer is detected from the exact survivor counts and rerouted to
    the exact sort: that check reads the counts on the host, one device
    sync per call.  A degenerate budget (T_pad ≥ N) sorts directly.

    ``with_count=True`` appends the per-row survivor count (B,) int32
    (``WorkStats.candidates_selected``); the sort paths report T.
    """
    B, N = d.shape
    if not 1 <= T <= N:
        raise ValueError(f"radius_select: T={T} out of range for N={N}")
    if T_pad is None:
        T_pad = T + max(256, T // 8)
    T_pad = min(max(T_pad, T), N)
    plain = _plain(force, d)

    def _sort():
        vals, idx = ref.topk_smallest(d, T)
        return vals, idx, torch.full((B,), T, dtype=torch.int32, device=d.device)

    if T_pad >= N:  # nothing to skip: the plain sort is cheaper
        counts.route("radius_select.sort")
        vals, idx, cnt = _sort()
    else:
        if tau0 is None:
            tau0 = default_select_seed(d, T)
        select = ref.radius_select_kernel if plain else _select.radius_select
        vals_p, idx_p, cnt = select(d.to(torch.float32).contiguous(), tau0, T,
                                    T_pad=T_pad)
        # an overflowed buffer dropped survivors in index order, possibly
        # true top-T members: answer with the exact sort instead
        if bool((cnt > T_pad).any()):
            counts.route("radius_select.overflow")
            vals, idx, cnt = _sort()
        else:
            vals, pos = ref.topk_smallest(vals_p, T)
            idx = torch.gather(idx_p, 1, pos.to(torch.int64))
    return (vals, idx, cnt) if with_count else (vals, idx)


def verify_topk(data: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, k: int, *,
                force: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused VERIFY: exact distances on candidate ids + top-k answer.

    data (n,d) × q (B,d) × cand (B,Tc) → (d² (B,k) ascending, ids (B,k)).
    k > 128 is past the kernel's answer width and takes the plain
    version on every device, as the reference routes it (ops.py:309).
    """
    if k > _verify.MAX_K:
        counts.route("verify_topk.k_over_128")
        return ref.verify_topk(data, q, cand, k)
    if _plain(force, data, q, cand):
        return ref.verify_topk(data, q, cand, k)
    return _verify.verify_topk(data.to(torch.float32).contiguous(),
                               q.to(torch.float32).contiguous(),
                               cand.to(torch.int32).contiguous(), k)


def adc_dist(codes: torch.Tensor, lut: torch.Tensor, *,
             force: str | None = None) -> torch.Tensor:
    """Asymmetric distances: codes (N, S) or per-query (B, N, S) × LUTs
    (B, S, V) → (B, N).  The kernel reads the codes as uint8."""
    if _plain(force, codes, lut):
        return ref.adc_dist(codes, lut)
    return _adc.adc_dist(codes.to(torch.uint8).contiguous(),
                         lut.to(torch.float32).contiguous())


def pair_join(x: torch.Tensor, key: torch.Tensor, k: int, *, thresh2: float,
              force: str | None = None):
    """Top-k closest pairs of x's rows by pruned blockwise self-join.

    x (n, d) sorted ascending by key (n,) → (d² (k,) ascending, pi (k,),
    pj (k,), stats (3,) int64 = [pairs_verified, tiles_pruned,
    bands_joined]); pi < pj are row POSITIONS in the sorted order,
    (+inf, −1, −1) past the real pair count.  ``thresh2`` = (γ·t)² is
    Algorithm 4's radius filter as tile masking; ``float('inf')``
    disables pruning.  k > 128 is past the kernel's pair heap and takes
    the plain version on every device, as the reference routes it
    (ops.py:268).

    The CUDA kernel is bound by float32 multiply-adds on CUDA cores (2·d
    flops a verified pair).  Where the TPU kernel walks its tiles in one
    serial grid, it runs the sweep as one cooperative launch: groups of
    bands whose candidate tiles the whole card joins under the group's
    first ub², each folded in order by one warp, 32 tiles a ballot, with
    no read back to the host.
    """
    if k > _pair_join.MAX_K:
        counts.route("pair_join.k_over_128")
        return ref.pair_join(x, key, k, thresh2=thresh2)
    if _plain(force, x, key):
        return ref.pair_join(x, key, k, thresh2=thresh2)
    return _pair_join.pair_join(x.to(torch.float32).contiguous(),
                                key.to(torch.float32).contiguous(), k,
                                thresh2=float(thresh2))
