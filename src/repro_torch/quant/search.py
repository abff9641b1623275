"""The quantized query pipeline, the counterpart of ``repro.quant.search``.

The flat pipeline's estimate → select → verify gains an ADC rerank tier
between select and verify:

    1. estimate:  projected distances ||x@A − q'||²      (pairwise kernel)
    2. select:    the T = βn + k projected-nearest         candidates C
    3. rerank:    ADC distances on the codes of C → top R  (adc kernel)
    4. verify:    exact distances on the R float rows      (or, with
                  ``store_raw=False``, answer from the ADC estimates)

Closest pair over quantized storage joins the decoded codes and, where
the raw rows are kept, re-verifies the R best estimated pairs exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cp_fused import cp_fused_search
from ..core.flat_index import FlatIndex
from ..core.fused import select_seed
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs import trace as otrace

__all__ = ["quant_ann_query", "quant_cp_search"]


def quant_ann_query(index: FlatIndex, codec, codes: torch.Tensor, q: torch.Tensor, *,
                    k: int, T: int, R: int, store_raw: bool = True,
                    force: str | None = None, fused: bool = False,
                    with_count: bool = False):
    """(c,k)-ANN over quantized storage.

    While tracing, each tier runs under a ``quant.*`` span
    (``quant.query`` over ``quant.estimate``, ``quant.select``,
    ``quant.rerank``, ``quant.verify``; kernel spans nest underneath)
    with its outputs synchronized before the span closes; with tracing
    off a span is a shared no-op and nothing synchronizes.

    Args:
      index: the flat index (its ``data`` may be empty when
        ``store_raw=False``).
      codec: the trained codec; codes: (n, S) uint8 codes of every point.
      q: (B, d) query batch on the index's device.
      k / T / R: answer size, candidate budget (βn + k), rerank budget.
      store_raw: verify the R reranked candidates against the float rows
        (exact distances), or answer from the ADC estimates.
      fused: radius-threshold select for the T cut and (R > 128) the R
        cut, and the gather-free verify kernel; identical answers on
        ties-free data.
      force: kernel dispatch override (None or "plain").
      with_count: also return the T-select's per-query survivor counts.

    Returns (indices (B, k) int32, distances (B, k) float32), plus the
    counts when ``with_count``.
    """
    if not k <= R <= T:
        raise ValueError(f"need k <= R <= T, got k={k} R={R} T={T}")
    q = q.to(torch.float32)
    if q.ndim == 1:
        q = q[None]
    with otrace.span("quant.query", B=int(q.shape[0]), n=int(codes.shape[0]),
                     k=k, T=T, R=R, fused=fused, store_raw=store_raw):
        # 1-2. estimate + select (identical to the float pipeline)
        with otrace.span("quant.estimate"):
            qp = index.family.project(q)  # (B, m)
            d2p = kops.pairwise_sq_dist(qp, index.projected, force=force)  # (B, n)
        with otrace.span("quant.select") as sp:
            if fused:
                m = index.params.m if index.params is not None else index.m
                tau0 = select_seed(d2p, T, m)
                _, cand, cnt = kops.radius_select(d2p, T, tau0=tau0, force=force,
                                                  with_count=True)
            else:
                _, cand = kref.topk_smallest(d2p, T)  # (B, T)
                cnt = torch.full((q.shape[0],), T, dtype=torch.int32,
                                 device=q.device)
            otrace.block(cand)
            if sp is not None:
                sp.attrs["candidates_selected"] = int(cnt.sum())

        # 3. rerank: ADC on the candidates' uint8 codes, keep the R best
        with otrace.span("quant.rerank"):
            ccodes = codes[cand.to(torch.int64)]  # (B, T, S)
            direct = getattr(codec, "adc_direct", None)
            if direct is not None:  # affine codecs skip the tables
                d2a = direct(q, ccodes)
            else:
                d2a = kops.adc_dist(ccodes, codec.lookup_tables(q), force=force)  # (B, T)
            if fused and R > 128:
                adcR, selR = kops.radius_select(d2a, R, force=force)
            else:
                adcR, selR = kref.topk_smallest(d2a, R)
            rcand = otrace.block(torch.gather(cand, 1, selR.to(torch.int64)))  # (B, R)

        with otrace.span("quant.verify"):
            if not store_raw:  # the R cut is already ascending in ADC distance
                out = (rcand[:, :k].to(torch.int32),
                       torch.sqrt(torch.clamp_min(adcR[:, :k], 0.0)))
            elif fused:
                d2, idx = kops.verify_topk(index.data, q, rcand, k, force=force)
                out = idx.to(torch.int32), torch.sqrt(torch.clamp_min(d2, 0.0))
            else:
                rows = index.data[rcand.to(torch.int64)]  # (B, R, d)
                d2 = kops.pairwise_sq_dist(q, rows, force=force)
                vals, sel = kref.topk_smallest(d2, k)
                idx = torch.gather(rcand, 1, sel.to(torch.int64))
                out = idx.to(torch.int32), torch.sqrt(torch.clamp_min(vals, 0.0))
            out = otrace.block(*out)
    return out + (cnt,) if with_count else out


def quant_cp_search(codec, codes: torch.Tensor, key: torch.Tensor, k: int, *,
                    raw: torch.Tensor | None = None, R: int | None = None,
                    c: float = 4.0, m: int = 15, gamma: float = 1.0,
                    force: str | None = None, recon: torch.Tensor | None = None):
    """(c,k)-ACP over quantized storage.

    The pair join runs on the points reconstructed from their codes and
    keeps the R best estimated pairs under the same γ·t·ub filter as the
    float path; with ``raw`` rows those R are re-verified exactly, else
    the estimates answer.  R defaults to max(4k, n/4, 64) capped at 1024;
    R > 128 takes the pair join's plain version (``ops.pair_join``).
    ``recon`` is an optional precomputed ``codec.decode(codes)``.

    Returns (pairs (k', 2) int32 ascending by distance, distances (k',)
    float32, pairs_estimated, pairs_verified, tiles_pruned).
    """
    if recon is None:
        recon = codec.decode(codes)
    n = recon.shape[0]
    R = min(max(4 * k, n // 4, 64), 1024) if R is None else int(R)
    R = min(max(R, k), max(n * (n - 1) // 2, 1))
    est = cp_fused_search(recon, R, m=m, c=c, gamma=gamma, force=force, key=key)
    if raw is None or est.pairs.shape[0] == 0:
        kk = min(k, est.pairs.shape[0])
        return (est.pairs[:kk], est.distances[:kk], est.pairs_verified,
                0, est.tiles_pruned)
    pairs = torch.from_numpy(est.pairs).to(raw.device, torch.int64)
    diff = raw[pairs[:, 0]] - raw[pairs[:, 1]]
    d = torch.sqrt((diff * diff).sum(1))
    order = torch.sort(d, stable=True).indices[:k]
    return (est.pairs[order.cpu().numpy()], d[order].cpu().numpy().astype(np.float32),
            est.pairs_verified, int(est.pairs.shape[0]), est.tiles_pruned)
