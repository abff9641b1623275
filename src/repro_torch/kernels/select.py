"""Wrapper of the CUDA radius-threshold selection kernel (csrc/select.cu).

Takes the place of ``repro.kernels.select.radius_select_pallas`` and of
the trim sort after it: each row's first T by (value, index), in
ascending INDEX order, padded with (+inf, −1) where a row has fewer than
T real entries, and the exact per-row survivor count count(d ≤ hi) of
the reference's threshold.  Nothing is read back to the host.  The plain
version is ``repro_torch.kernels.ref.radius_select_exact``; both take
their rung thresholds from ``ref.select_rungs``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump
from .ref import select_rungs

__all__ = ["radius_select"]


@functools.cache
def _rungs() -> ctypes.Array:
    """The 16 rung factors as a host array, built once per process."""
    factors = select_rungs().tolist()
    return (ctypes.c_float * len(factors))(*factors)


def radius_select(d: torch.Tensor, tau0: torch.Tensor, T: int, *, stats: bool = False):
    """d (B, N) float32, tau0 (B,) float32 CUDA tensors → (vals (B, T)
    float32, idx (B, T) int32, count (B,) int32), and with ``stats`` the
    (B, 3) int32 [final band size, entries of the last pass's bracket, 1
    where the row was resolved over the whole row] the kernel leaves on
    the card."""
    checked("radius_select d", d, torch.float32, 2)
    B, N = d.shape
    if tau0.shape != (B,):
        raise ValueError(f"radius_select: tau0 {tuple(tau0.shape)} for d {tuple(d.shape)}")
    if not 1 <= T <= N:
        raise ValueError(f"radius_select: T={T} out of range for N={N}")
    if B > 65535 or N > 2**31 - 1:
        raise ValueError(f"radius_select: shape {tuple(d.shape)} too large")
    tau0 = checked("radius_select tau0",
                   torch.clamp_min(tau0.to(torch.float32), 1e-30).contiguous(),
                   torch.float32, 1, d.device)
    lib = _build.load()
    scratch = torch.empty(lib.radius_select_scratch_ints(B, N),
                          dtype=torch.int32, device=d.device)
    vals = torch.empty((B, T), dtype=torch.float32, device=d.device)
    idx = torch.empty((B, T), dtype=torch.int32, device=d.device)
    count = torch.empty((B,), dtype=torch.int32, device=d.device)
    row_stats = torch.empty((B, 3), dtype=torch.int32, device=d.device)
    err = lib.radius_select_launch(
        d.data_ptr(), tau0.data_ptr(), ctypes.cast(_rungs(), ctypes.c_void_p),
        B, N, T, vals.data_ptr(), idx.data_ptr(), count.data_ptr(),
        row_stats.data_ptr(), scratch.data_ptr(), stream_of(d))
    _build.check(err, "radius_select")
    bump("radius_select")
    return (vals, idx, count, row_stats) if stats else (vals, idx, count)
