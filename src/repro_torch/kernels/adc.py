"""Wrapper of the CUDA asymmetric-distance kernel (csrc/adc.cu).

Replaces ``repro.kernels.adc.adc_dist_pallas`` (and the per-query form
that ``repro.kernels.ops.adc_dist`` vmaps over it): out[b, n] =
Σ_s lut[b, s, codes[..., n, s]], the rerank tier's distance from a float
query to a quantized point.  The codes stay uint8 in memory.  Sums run
in slot order from 0, as the plain version ``repro_torch.kernels.ref.
adc_dist`` adds, so the two agree exactly.  A code at or past V reads a
zero entry.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_V", "adc_dist"]

MAX_V = 256  # one table row per slot in shared memory; codes are uint8


def adc_dist(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (N, S) or (B, N, S) uint8, lut (B, S, V) float32 CUDA
    tensors → (B, N) float32."""
    checked("adc_dist lut", lut, torch.float32, 3)
    B, S, V = lut.shape
    if codes.ndim == 3:
        checked("adc_dist codes", codes, torch.uint8, 3, lut.device)
        if codes.shape[0] != B:
            raise ValueError(f"adc_dist: codes {tuple(codes.shape)} for lut {tuple(lut.shape)}")
    else:
        checked("adc_dist codes", codes, torch.uint8, 2, lut.device)
    N = codes.shape[-2]
    if codes.shape[-1] != S:
        raise ValueError(f"adc_dist: codes {tuple(codes.shape)} for lut {tuple(lut.shape)}")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"adc_dist: V={V} outside [1, {MAX_V}]")
    if B > 65535 or N > 2**31 - 1:
        raise ValueError(f"adc_dist: shape ({B}, {N}, {S}) too large")
    out = torch.empty((B, N), dtype=torch.float32, device=lut.device)
    if B == 0 or N == 0:
        return out
    lib = _build.load()
    batch_stride = N * S if codes.ndim == 3 else 0
    err = lib.adc_dist_launch(codes.data_ptr(), batch_stride, lut.data_ptr(),
                              out.data_ptr(), B, N, S, V, stream_of(lut))
    _build.check(err, "adc_dist")
    bump("adc_dist")
    return out
