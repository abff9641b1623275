"""Wrapper of the CUDA fused projection + distance kernel
(csrc/project_dist.cu).

Replaces ``repro.kernels.project_dist.project_dist_pallas``: x (N, d),
A (d, m) and projected queries qp (B, m) → (B, N) squared projected
distances max(|qp|² + |x·A|² − 2·qp·(x·A), 0), without writing the
(N, m) projection to device memory.  The plain version is
``repro_torch.kernels.ref.project_dist``; the two sum the projection in
another order, so they agree to |Δ| ≤ 1e-5·(|qp|² + |x·A|²) + 1e-6.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_M", "project_dist"]

MAX_M = 32  # the projected coordinates of a point live in registers


def project_dist(x: torch.Tensor, a: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """x (N, d), a (d, m), qp (B, m) float32 CUDA tensors → (B, N)."""
    checked("project_dist x", x, torch.float32, 2)
    checked("project_dist a", a, torch.float32, 2, x.device)
    checked("project_dist qp", qp, torch.float32, 2, x.device)
    (N, d), (B, m) = x.shape, qp.shape
    if a.shape != (d, m):
        raise ValueError(f"project_dist: a {tuple(a.shape)} for x {tuple(x.shape)} "
                         f"and qp {tuple(qp.shape)}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"project_dist: m={m} outside [1, {MAX_M}]")
    if N > 2**31 - 1:
        raise ValueError(f"project_dist: N={N} too large")
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    err = lib.project_dist_launch(x.data_ptr(), a.data_ptr(), qp.data_ptr(),
                                  out.data_ptr(), B, N, d, m, stream_of(x))
    _build.check(err, "project_dist")
    bump("project_dist")
    return out
