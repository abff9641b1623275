"""Wrapper of the CUDA gather-free verification kernel (csrc/verify.cu).

Replaces ``repro.kernels.verify.verify_topk_pallas``: exact squared
distances from each query to its candidate rows of ``data`` (ids −1 are
padding) and the k ≤ 128 smallest, ascending, ties to the earliest
candidate position; slots past a row's real candidates answer
(+inf, −1).  Distances are summed in the difference form, where the TPU
kernel uses the norm trick.  The plain version is
``repro_torch.kernels.ref.verify_topk``.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump

__all__ = ["MAX_K", "verify_topk"]

MAX_K = 128
_MAX_D = 8192  # the query row lives in the block's dynamic shared memory


@functools.cache
def _wave(device: torch.device, d: int) -> int:
    """Blocks of the kernel at width d one wave of ``device`` holds: the
    occupancy query and the SM count, asked once per (device, d)."""
    with torch.cuda.device(device):
        per_sm = _build.load().verify_topk_blocks_per_sm(d)
    if per_sm < 1:
        raise RuntimeError(f"verify_topk: no block of the kernel fits an SM at d={d}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _splits(B: int, Tc: int, d: int, device: torch.device) -> int:
    """Splits of Tc per query: as many blocks as the card holds in one
    wave (a second, part-filled wave would double the time), but no
    split shorter than 256 candidates."""
    if Tc == 0:
        return 1
    S = max(1, min(_wave(device, d) // B, math.ceil(Tc / 256)))
    return math.ceil(Tc / math.ceil(Tc / S))  # no empty split


def verify_topk(data: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """data (n, d) float32, q (B, d) float32, cand (B, Tc) int32 CUDA
    tensors → (d² (B, k) float32 ascending, ids (B, k) int32)."""
    checked("verify_topk data", data, torch.float32, 2)
    checked("verify_topk q", q, torch.float32, 2, data.device)
    checked("verify_topk cand", cand, torch.int32, 2, data.device)
    d = data.shape[1]
    B, Tc = cand.shape
    if q.shape != (B, d):
        raise ValueError(f"verify_topk: q {tuple(q.shape)} for data "
                         f"{tuple(data.shape)} and cand {tuple(cand.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"verify_topk: k={k} outside [1, {MAX_K}]; "
                         "ops.verify_topk routes k > 128 to the plain version")
    if d > _MAX_D or B > 65535:
        raise ValueError(f"verify_topk: d={d} or B={B} too large")
    vals = torch.empty((B, k), dtype=torch.float32, device=data.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=data.device)
    if B == 0:
        return vals, ids
    lib = _build.load()
    S = _splits(B, Tc, d, data.device)
    part_v = torch.empty((B, S, k), dtype=torch.float32, device=data.device)
    part_p = torch.empty((B, S, k), dtype=torch.int32, device=data.device)
    err = lib.verify_topk_launch(
        data.data_ptr(), q.data_ptr(), cand.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), part_v.data_ptr(), part_p.data_ptr(), d, B, Tc, k, S,
        stream_of(data))
    _build.check(err, "verify_topk")
    bump("verify_topk")
    return vals, ids
