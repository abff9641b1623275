"""Wrappers of the CUDA pairwise squared-distance kernels.

``pairwise_sq_dist``      (B, d) × (N, d) → (B, N), norm trick, clamped
                          at 0: the ESTIMATE step and the unfused path's
                          projected distances (csrc/pairwise_dist.cu).
``pairwise_sq_dist_rows`` (B, d) × (B, N, d) → (B, N), difference form:
                          the unfused VERIFY step's gathered rows.

Both replace ``repro.kernels.pairwise_dist.pairwise_sq_dist_pallas``
(the TPU kernel, vmapped for the per-query form).  The plain versions
are ``repro_torch.kernels.ref.pairwise_sq_dist``.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["pairwise_sq_dist", "pairwise_sq_dist_rows"]

_I32_MAX = 2**31 - 1


def pairwise_sq_dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, d) × (N, d) float32 CUDA tensors → (B, N) squared distances."""
    checked("pairwise_sq_dist q", q, torch.float32, 2)
    checked("pairwise_sq_dist x", x, torch.float32, 2, q.device)
    (B, d), N = q.shape, x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"pairwise_sq_dist: q has d={d}, x has d={x.shape[1]}")
    if max(B, N) > _I32_MAX:
        raise ValueError(f"pairwise_sq_dist: shape ({B}, {N}, {d}) too large")
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    err = lib.pairwise_sq_dist_launch(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                      B, N, d, stream_of(q))
    _build.check(err, "pairwise_sq_dist")
    bump("pairwise_sq_dist")
    return out


def pairwise_sq_dist_rows(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, d) × (B, N, d) float32 CUDA tensors → (B, N): out[b, i] =
    Σ (x[b, i] − q[b])², summed in the difference form."""
    checked("pairwise_sq_dist_rows q", q, torch.float32, 2)
    checked("pairwise_sq_dist_rows x", x, torch.float32, 3, q.device)
    B, d = q.shape
    if x.shape[0] != B or x.shape[2] != d:
        raise ValueError(f"pairwise_sq_dist_rows: q {tuple(q.shape)} vs x "
                         f"{tuple(x.shape)}")
    N = x.shape[1]
    if B > 65535 or N > _I32_MAX:
        raise ValueError(f"pairwise_sq_dist_rows: shape {tuple(x.shape)} too large")
    out = torch.empty((B, N), dtype=torch.float32, device=q.device)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    err = lib.pairwise_sq_dist_rows_launch(q.data_ptr(), x.data_ptr(),
                                           out.data_ptr(), B, N, d, stream_of(q))
    _build.check(err, "pairwise_sq_dist_rows")
    bump("pairwise_sq_dist_rows")
    return out
