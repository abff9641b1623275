"""Wrapper of the CUDA pruned closest-pair self-join (csrc/pair_join.cu).

Replaces ``repro.kernels.pair_join.pair_join_pallas``: the top-k ≤ 128
closest pairs among the rows of x (n, d), sorted by key (n,), by the
band-major tile sweep with Algorithm 4's radius filter as tile skipping.
The answer and the counters are those of the serial sweep, which the
plain version ``repro_torch.kernels.ref.pair_join`` walks tile by tile.

The kernel runs two launches per band and stops when a band prunes
every tile (every later band would prune too).  The wrapper enqueues
the bands in groups of 4, 8, 16, … and reads the stop flag on the host
between groups: one device sync per group.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump
from .ref import _pair_join_block

__all__ = ["MAX_K", "pair_join"]

MAX_K = 128
_FIRST_GROUP = 4  # bands enqueued before the first read of the stop flag


def pair_join(x: torch.Tensor, key: torch.Tensor, k: int, *, thresh2: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (n, d) float32, key (n,) float32 CUDA tensors → (d² (k,) float32
    ascending, pi (k,) int32, pj (k,) int32, stats (3,) int64 =
    [pairs_verified, tiles_pruned, bands_joined])."""
    checked("pair_join x", x, torch.float32, 2)
    checked("pair_join key", key, torch.float32, 1, x.device)
    n, d = x.shape
    if key.shape != (n,):
        raise ValueError(f"pair_join: key {tuple(key.shape)} for x {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pair_join: k={k} outside [1, {MAX_K}]; "
                         "ops.pair_join routes k > 128 to the plain version")
    if n < 1 or d < 1 or n > 2**31 - 1:
        raise ValueError(f"pair_join: shape {tuple(x.shape)} out of range")
    bN = _pair_join_block(n)
    n_ti = -(-n // bN)
    dev = x.device
    heap_v = torch.full((k,), float("inf"), dtype=torch.float32, device=dev)
    heap_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    heap_j = torch.full((k,), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros((3,), dtype=torch.int64, device=dev)
    stop = torch.zeros((1,), dtype=torch.int32, device=dev)
    tile_v = torch.empty((n_ti, k), dtype=torch.float32, device=dev)
    tile_p = torch.empty((n_ti, k), dtype=torch.int32, device=dev)
    lib = _build.load()
    stream = stream_of(x)
    band, group = 0, _FIRST_GROUP
    while band < n_ti:
        bands = min(group, n_ti - band)
        err = lib.pair_join_bands_launch(
            x.data_ptr(), key.data_ptr(), n, d, bN, n_ti, band, bands, k,
            float(thresh2), heap_v.data_ptr(), heap_i.data_ptr(),
            heap_j.data_ptr(), stats.data_ptr(), stop.data_ptr(),
            tile_v.data_ptr(), tile_p.data_ptr(), stream)
        _build.check(err, "pair_join")
        band, group = band + bands, 2 * group
        if band < n_ti and bool(stop.item()):
            break
    bump("pair_join")
    return heap_v, heap_i, heap_j, stats
