"""Wrapper of the CUDA row-wise k-smallest kernel (csrc/topk.cu).

Replaces ``repro.kernels.topk.topk_smallest_pallas``: the k ≤ 128
smallest entries of each row of d (B, N), ascending, ties to the lowest
index, with the plain version's contract exactly
(``repro_torch.kernels.ref.topk_smallest``, a stable sort): +inf entries
take part like any value, so a row with fewer than k finite entries
answers the sort's indices, not the TPU kernel's repeated ones.  Values
are copies of the input and agree bit for bit.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_K", "topk_smallest"]

MAX_K = 128
_BUF = 2048  # keys a block sorts at a time (csrc/topk.cu kBuf)


@functools.cache
def _wave(device: torch.device) -> int:
    """Blocks of the kernel one wave of ``device`` holds: the occupancy
    query and the SM count, asked once per device."""
    with torch.cuda.device(device):
        per_sm = _build.load().topk_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("topk_smallest: no block of the kernel fits an SM")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _splits(B: int, N: int, device: torch.device) -> int:
    """Splits of each row: as many blocks as the card holds in one wave,
    but no split shorter than one buffer of keys."""
    S = max(1, min(_wave(device) // B, math.ceil(N / _BUF)))
    return math.ceil(N / math.ceil(N / S))  # no empty split


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """d (B, N) float32 CUDA tensor → (values (B, k) float32 ascending,
    indices (B, k) int32)."""
    checked("topk_smallest d", d, torch.float32, 2)
    B, N = d.shape
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"topk_smallest: k={k} outside [1, min({MAX_K}, N={N})]; "
                         "ops.topk_smallest routes k > 128 to radius_select")
    if B > 65535 or N > 2**31 - 1:
        raise ValueError(f"topk_smallest: shape ({B}, {N}) too large")
    vals = torch.empty((B, k), dtype=torch.float32, device=d.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=d.device)
    if B == 0:
        return vals, idx
    lib = _build.load()
    S = _splits(B, N, d.device)
    part = torch.empty((B, S, k) if S > 1 else (0,), dtype=torch.int64, device=d.device)
    err = lib.topk_smallest_launch(d.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                   part.data_ptr(), B, N, k, S, stream_of(d))
    _build.check(err, "topk_smallest")
    bump("topk_smallest")
    return vals, idx
