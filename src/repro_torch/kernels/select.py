"""Wrapper of the CUDA radius-threshold selection kernel (csrc/select.cu).

Replaces ``repro.kernels.select.radius_select_pallas`` with the same
contract: the survivors d ≤ hi of each row in ascending INDEX order,
padded with (+inf, −1) to T_pad slots, and the exact per-row survivor
count, which exceeds T_pad when the buffer overflowed (the caller,
``ops.radius_select``, then reroutes to the exact sort).  The plain
version is ``repro_torch.kernels.ref.radius_select_kernel``; both take
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


def radius_select(d: torch.Tensor, tau0: torch.Tensor, T: int, *, T_pad: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """d (B, N) float32, tau0 (B,) float32 CUDA tensors → (vals (B, T_pad)
    float32, idx (B, T_pad) int32, count (B,) int32)."""
    checked("radius_select d", d, torch.float32, 2)
    B, N = d.shape
    if tau0.shape != (B,):
        raise ValueError(f"radius_select: tau0 {tuple(tau0.shape)} for d {tuple(d.shape)}")
    if not 1 <= T <= N:
        raise ValueError(f"radius_select: T={T} out of range for N={N}")
    if T_pad < T:
        raise ValueError(f"radius_select: T_pad={T_pad} < T={T}")
    if B > 65535 or N > 2**31 - 1:
        raise ValueError(f"radius_select: shape {tuple(d.shape)} too large")
    tau0 = checked("radius_select tau0",
                   torch.clamp_min(tau0.to(torch.float32), 1e-30).contiguous(),
                   torch.float32, 1, d.device)
    lib = _build.load()
    scratch = torch.empty(lib.radius_select_scratch_ints(B, N),
                          dtype=torch.int32, device=d.device)
    vals = torch.empty((B, T_pad), dtype=torch.float32, device=d.device)
    idx = torch.empty((B, T_pad), dtype=torch.int32, device=d.device)
    count = torch.empty((B,), dtype=torch.int32, device=d.device)
    err = lib.radius_select_launch(
        d.data_ptr(), tau0.data_ptr(), ctypes.cast(_rungs(), ctypes.c_void_p),
        B, N, T, T_pad, vals.data_ptr(), idx.data_ptr(),
        count.data_ptr(), scratch.data_ptr(), stream_of(d))
    _build.check(err, "radius_select")
    bump("radius_select")
    return vals, idx, count
