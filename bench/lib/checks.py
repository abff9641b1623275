"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``bench/reference``).

Each comparison returns plain numbers; the cell's traffic file gives each
number its limit, and a run is correct when every number is at or under
its limit.  A number that cannot be read (a missing answer, a NaN) is
``WORST``, so it fails any limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["WORST", "ann_numbers", "cp_numbers", "worst"]

#: the reading of a number that could not be taken: above every limit
WORST = 1e30


def worst(*values: float) -> float:
    """The largest of ``values``, with anything not finite read as WORST."""
    out = 0.0
    for v in values:
        v = float(v)
        out = max(out, v if math.isfinite(v) else WORST)
    return out


def ann_numbers(ref, q: torch.Tensor, ids, dist, k: int, T: int | None = None) -> dict:
    """Compare one batch of answers (ids, dist: (B, k) numpy) for queries
    q (B, d) with the reference's answers at budget T.

    ``missed``: reference ids absent from the program's answer row (an
    invalid, repeated or absent id never matches), of ``slots`` = B k.
    ``dist_err``: the largest |d - d_ref| / d_ref over the program's
    answers, d_ref the float64 distance of the id the program named.
    """
    B = q.shape[0]
    ids = np.asarray(ids)
    dist = np.asarray(dist, dtype=np.float64)
    if ids.shape != (B, k) or dist.shape != (B, k):
        return {"missed": B * k, "slots": B * k, "dist_err": WORST}
    ref_ids, _ = ref.answer(q, k, T)
    got = torch.from_numpy(ids.astype(np.int64)).to(ref_ids.device)
    valid = (got >= 0) & (got < ref.n)
    got = torch.where(valid, got, torch.full_like(got, -1))
    matched = (ref_ids[:, :, None] == got[:, None, :]).any(-1)
    missed = int((~matched).sum())
    d_ref = ref.distances(q, got).cpu().numpy()
    rel = np.abs(dist - d_ref) / np.maximum(d_ref, 1e-12)
    rel = np.where(valid.cpu().numpy(), rel, np.inf)
    return {"missed": missed, "slots": B * k, "dist_err": worst(rel.max())}


def cp_numbers(ref, pairs, dist, k: int, nearest: tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Compare one closest-pair answer (pairs (k', 2), dist (k',) numpy)
    with the k nearest pairs ``nearest`` = (pairs (k, 2), float64
    distances (k,) ascending) of ``CpReference.nearest``.

    ``ratio``: the largest over ranks i of the i-th smallest true distance
    among the answer's pairs over the i-th smallest of all pairs: the
    approximation ratio of a (c, k)-ACP answer (an answer short of k
    pairs, or with a pair that is invalid or repeated, reads WORST).
    ``dist_err``: the largest |d - d_ref| / d_ref of the answer's pairs.
    ``found``: the share of the ``wanted`` = k nearest pairs in the answer.
    """
    k = min(int(k), ref.n * (ref.n - 1) // 2)
    pairs = np.asarray(pairs).reshape(-1, 2).astype(np.int64)
    dist = np.asarray(dist, dtype=np.float64).reshape(-1)
    if pairs.shape[0] != k or dist.shape[0] != k:
        return {"ratio": WORST, "dist_err": WORST, "found": 0.0, "wanted": k}
    i, j = pairs[:, 0], pairs[:, 1]
    ok = (i >= 0) & (j < ref.n) & (i < j)
    codes = i * ref.n + j
    valid = bool(ok.all()) and len(np.unique(codes)) == k
    pt = torch.from_numpy(np.where(ok[:, None], pairs, 0)).to(ref.rows.device)
    d_true = ref.distances(pt).cpu().numpy()
    rel = np.where(ok, np.abs(dist - d_true) / np.maximum(d_true, 1e-12), np.inf)
    near_pairs, near_dist = nearest
    best = near_dist.cpu().numpy().astype(np.float64)
    ratio = float(np.max(np.sort(d_true) / np.maximum(best, 1e-12))) if valid else WORST
    want = near_pairs.cpu().numpy()
    found = np.isin(want[:, 0] * ref.n + want[:, 1], codes[ok]).mean()
    return {"ratio": worst(ratio), "dist_err": worst(rel.max()), "found": float(found),
            "wanted": k}
