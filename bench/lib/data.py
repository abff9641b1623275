"""The inputs a run makes from its ``--seed``: the dataset's twin, its pool
of queries and the orders of its traffic, drawn on the run's device by
``torch.Generator``s in a few large calls.  The mixture the rows are drawn
from (its cluster centres and directions) is the configuration's own,
fixed by its ``mixture_seed``; every seed draws its own rows from it (which
cluster, where along its directions, the noise) and its own queries, so
every seed holds a collection of its own with the same law, and offers the
same amount of work.  The traffic's sizes and arrivals are the same for
every seed, in an order of its own.

The twin is the clustered Gaussian mixture of the repository's Deep and
Audio twins (``chip_smoke.make_clustered_twin``), rewritten in torch so
that it is drawn on the card: cluster centres at scale 6, inside each
cluster a spread along ``active`` unit directions (the local intrinsic
dimension), and a pinch of full-rank noise so that no two distances tie.
Queries are dataset points with a small jitter (paper section 7.1), drawn
without replacement so that no two queries share a point.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["sub_seed", "generator", "clustered_twin", "jittered_queries",
           "fixed_order"]

CENTER_SCALE = 6.0
NOISE = 0.05
JITTER = 0.05
CHUNK = 131072


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run: any whole ``seed`` (however
    large) and ``tag`` give the same number every time."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def clustered_twin(n: int, d: int, clusters: int, active: int, mixture_seed: int,
                   seed: int, device: torch.device) -> torch.Tensor:
    """(n, d) float32 rows drawn by ``seed`` from the mixture of
    ``mixture_seed``, on ``device``."""
    m = generator(mixture_seed, "mixture", device)
    centers = torch.randn((clusters, d), generator=m, device=device) * CENTER_SCALE
    basis = torch.randn((clusters, active, d), generator=m, device=device)
    basis /= basis.norm(dim=-1, keepdim=True)
    g = generator(seed, "rows", device)
    assign = torch.randint(0, clusters, (n,), generator=g, device=device)
    coeff = torch.randn((n, active), generator=g, device=device)
    rows = torch.randn((n, d), generator=g, device=device) * NOISE
    for s in range(0, n, CHUNK):
        a = assign[s:s + CHUNK]
        rows[s:s + CHUNK] += centers[a] + torch.bmm(coeff[s:s + CHUNK, None, :],
                                                    basis[a])[:, 0]
    return rows


def jittered_queries(rows: torch.Tensor, count: int, seed: int) -> torch.Tensor:
    """(count, d) queries: distinct rows plus Gaussian jitter whose norm is
    ``JITTER`` times the norm of the rows' per-dimension spread."""
    n, d = rows.shape
    if count > n:
        raise ValueError(f"{count} queries from {n} rows")
    g = generator(seed, "queries", rows.device)
    ids = torch.randperm(n, generator=g, device=rows.device)[:count]
    scale = JITTER * rows.std(0).norm() / math.sqrt(d)
    jitter = torch.randn((count, d), generator=g, device=rows.device)
    return rows[ids] + jitter * scale


def fixed_order(values: list, length: int, seed: int, tag: str) -> np.ndarray:
    """``length`` entries holding each of ``values`` equally often (as near as
    ``length`` allows), in an order drawn from ``seed``: every seed gets the
    same work in another order."""
    reps = -(-length // len(values))
    pool = np.tile(np.asarray(values), reps)[:length]
    rng = np.random.default_rng(sub_seed(seed, tag))
    return pool[rng.permutation(length)]
