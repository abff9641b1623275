"""Wrapper of the CUDA gather-free verification kernels (csrc/verify.cu).

Replaces ``repro.kernels.verify.verify_topk_pallas``: exact squared
distances from each query to its candidate rows of ``data`` (ids −1 are
padding) and the k ≤ 128 smallest, ascending, ties to the earliest
candidate position; slots past a row's real candidates answer
(+inf, −1).  Distances are summed in the difference form, where the TPU
kernel uses the norm trick.  The plain version is
``repro_torch.kernels.ref.verify_topk``.

The C entry sorts the batch's (query, position) entries by row id, so
each distinct candidate row is read once per group of queries
(``group_size``), writes each d² at its (query, position), and answers
through the topk kernel, as the plain version answers through
``topk_smallest``.  Ids outside [0, n) count as padding.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_K", "group_size", "verify_topk"]

MAX_K = 128
_MAX_D = 8192


def group_size(B: int, d: int) -> int:
    """Queries the kernel verifies at once at width d (their rows fit its
    shared memory): a batch of more is verified group by group, and a
    candidate row is read once a group."""
    return _build.load().verify_topk_group_size(B, d)


def verify_topk(data: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, k: int, *,
                rows_read: bool = False):
    """data (n, d) float32, q (B, d) float32, cand (B, Tc) int32 CUDA
    tensors → (d² (B, k) float32 ascending, ids (B, k) int32), and with
    ``rows_read=True`` a (1,) int32 tensor: the rows the distance passes
    read, the distinct ids of cand in each group, summed over groups."""
    checked("verify_topk data", data, torch.float32, 2)
    checked("verify_topk q", q, torch.float32, 2, data.device)
    checked("verify_topk cand", cand, torch.int32, 2, data.device)
    n, d = data.shape
    B, Tc = cand.shape
    if q.shape != (B, d):
        raise ValueError(f"verify_topk: q {tuple(q.shape)} for data "
                         f"{tuple(data.shape)} and cand {tuple(cand.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"verify_topk: k={k} outside [1, {MAX_K}]; "
                         "ops.verify_topk routes k > 128 to the plain version")
    if not 1 <= d <= _MAX_D or B > 65535 or B * max(Tc, k) > 2**31 - 1:
        raise ValueError(f"verify_topk: d={d}, B={B} or B·max(Tc, k)={B * max(Tc, k)} "
                         f"outside the kernel's range (d ≤ {_MAX_D}, B ≤ 65535, "
                         "B·max(Tc, k) < 2**31)")
    lib = _build.load()
    out = torch.empty(2 * B * k + 1, dtype=torch.int32, device=data.device)
    vals = out[:B * k].view(torch.float32).view(B, k)
    ids = out[B * k:2 * B * k].view(B, k)
    scratch = torch.empty(lib.verify_topk_scratch_bytes(n, d, B, Tc, k), dtype=torch.uint8,
                          device=data.device)
    err = lib.verify_topk_launch(
        data.data_ptr(), q.data_ptr(), cand.data_ptr(), vals.data_ptr(), ids.data_ptr(),
        out.data_ptr() + 8 * B * k, scratch.data_ptr(), n, d, B, Tc, k, stream_of(data))
    _build.check(err, "verify_topk")
    bump("verify_topk")
    return (vals, ids, out[2 * B * k:]) if rows_read else (vals, ids)
