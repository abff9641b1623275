"""Wrapper of the CUDA pruned closest-pair self-join (csrc/pair_join.cu).

Replaces ``repro.kernels.pair_join.pair_join_pallas``: the top-k ≤ 128
closest pairs among the rows of x (n, d), sorted by key (n,), by the
band-major tile sweep with Algorithm 4's radius filter as tile skipping.
The answer and the counters are those of the serial sweep, which the
plain version ``repro_torch.kernels.ref.pair_join`` walks tile by tile.

The whole sweep is one cooperative launch: the grid plans each group of
bands, joins its candidate tiles and folds them in order, and stops at
the first band that joins nothing (every later band would prune too).
The kernel writes the answer and the counters itself, so the call
allocates, launches once and returns without reading anything back.
"""
from __future__ import annotations

import torch

from . import _build
from ._args import checked, stream_of
from .counts import bump
from .ref import _pair_join_block

__all__ = ["MAX_K", "pair_join"]

MAX_K = 128


def pair_join(x: torch.Tensor, key: torch.Tensor, k: int, *, thresh2: float,
              sweep: bool = False):
    """x (n, d) float32, key (n,) float32 CUDA tensors → (d² (k,) float32
    ascending, pi (k,) int32, pj (k,) int32, stats (3,) int64 =
    [pairs_verified, tiles_pruned, bands_joined]), and with
    ``sweep=True`` a (5,) int64 tensor that describes the sweep: the ns
    it spent in its tile phases and in its plan and fold phases, barriers
    included, by the card's global timer, its groups of bands, the tiles
    it computed, and the tiles merged into the heap."""
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
    dev = x.device
    lib = _build.load()
    with torch.cuda.device(dev):
        nbytes = lib.pair_join_scratch_bytes(n, bN, k)
        if nbytes < 0:
            raise RuntimeError(f"repro_torch: pair_join could not size its grid on {dev}")
        heap_v = torch.empty((k,), dtype=torch.float32, device=dev)
        heap_i = torch.empty((k,), dtype=torch.int32, device=dev)
        heap_j = torch.empty((k,), dtype=torch.int32, device=dev)
        stats = torch.empty((3,), dtype=torch.int64, device=dev)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        err = lib.pair_join_launch(
            x.data_ptr(), key.data_ptr(), n, d, bN, k, float(thresh2), heap_v.data_ptr(),
            heap_i.data_ptr(), heap_j.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
            nbytes, stream_of(x))
    _build.check(err, "pair_join")
    bump("pair_join")
    out = heap_v, heap_i, heap_j, stats
    # the kernel's control words open the scratch, ints 8.. the sweep's
    return (*out, scratch[32:72].view(torch.int64)) if sweep else out
