"""The all-gather-of-k MERGE of the sharded ANN query, the counterpart of
``repro.kernels.merge``.

Every shard verifies its survivors into a local top-k_l; the merge pools
the P·k_l (distance², global id) pairs, the one payload the shards
exchange, and takes the global top-k.  The reference's merge is jnp, not
a Pallas kernel: the pool is a few KiB, so a torch function is its port.

Contract (``merge_topk_ref``): an ascending selection over the pooled
d² with ``lax.top_k``'s lowest-slot tie-break (the port's stable
``ref.topk_smallest``), id −1 wherever the winning slot is not finite
(a shard that held fewer than k_l survivors), distance sqrt(max(d², 0)).
"""
from __future__ import annotations

import torch

from . import ref

__all__ = ["merge_topk", "merge_topk_ref"]


def merge_topk_ref(d2_pool: torch.Tensor, gid_pool: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """d2_pool (B, L) float32, gid_pool (B, L) int32, L ≥ k → (ids (B, k)
    int32, distances (B, k) float32 ascending)."""
    d2, sel = ref.topk_smallest(d2_pool, k)
    ids = torch.gather(gid_pool, 1, sel.to(torch.int64))
    ids = torch.where(torch.isfinite(d2), ids, -1).to(torch.int32)
    return ids, torch.sqrt(torch.clamp_min(d2, 0.0))


def merge_topk(d2_pool: torch.Tensor, gid_pool: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge the sharded query runs: the contract itself, as in the
    reference (``repro/kernels/merge.py:53-58``)."""
    return merge_topk_ref(d2_pool, gid_pool, k)
