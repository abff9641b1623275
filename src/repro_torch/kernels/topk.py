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

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_K", "topk_smallest"]

MAX_K = 128
_SPLIT = 8192  # no split of a row shorter (csrc/common.cuh kTopkSplitMin)


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """d (B, N) float32 CUDA tensor → (values (B, k) float32 ascending,
    indices (B, k) int32).

    One allocation holds both answers and the partial keys of the split
    rows; the C entry sizes the splits to one wave of the card and
    rejects k outside [1, min(128, N)] and B past 65,535."""
    checked("topk_smallest d", d, torch.float32, 2)
    B, N = d.shape
    s_cap = -(-N // _SPLIT)
    part = B * s_cap * k if s_cap > 1 else 0  # 64-bit keys
    buf = torch.empty(2 * B * k + 2 * part, dtype=torch.int32, device=d.device)
    vals = buf[:B * k].view(torch.float32).view(B, k)
    idx = buf[B * k:2 * B * k].view(B, k)
    err = _build.load().topk_smallest_launch(
        d.data_ptr(), vals.data_ptr(), idx.data_ptr(), buf.data_ptr() + 8 * B * k,
        B, N, k, s_cap, stream_of(d))
    _build.check(err, f"topk_smallest at k={k}, shape ({B}, {N})")
    bump("topk_smallest")
    return vals, idx
