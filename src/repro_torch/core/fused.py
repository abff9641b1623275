"""The fused estimate → select → verify query pipeline, the counterpart
of ``repro.core.fused``.

Against the unfused pipeline in ``flat_index.ann_query`` it changes two
stages:

  SELECT   the sort over (B, n) for T = βn + k candidates becomes
           radius-threshold selection (``kernels/select``): the Eq. 9
           confidence interval turns rank T into a radius, found by a
           few O(n) counting passes seeded from the Lemma-2 estimate.
  VERIFY   the (B, T, d) candidate gather becomes the gather-free
           kernel (``kernels/verify``): each candidate row is read once
           and reduced in place.

Both keep exact parity with the unfused path on ties-free data.

The threshold seed: Lemma 2 says the projected squared distance of a
point at distance r concentrates at m·r²; Eq. 9's interval bounds it by
χ² quantiles.  So τ₀ = χ²_ppf(T/n; m) · (mean d'²/m), and the r·c^i
ladder absorbs the model's error.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..obs import trace as otrace
from .estimator import chi2_ppf
from .flat_index import FlatIndex

__all__ = ["fused_ann_query", "select_seed"]


def select_seed(d2p: torch.Tensor, T: int, m: int | None) -> torch.Tensor:
    """Per-row Eq. 9 / Lemma 2 seed for the radius-select ladder.

    d2p: (B, n) projected squared distances; T: candidate budget;
    m: projected dimensionality (None → plain sample-mean seed).
    Returns (B,) float32 seeds in squared projected units.
    """
    n = d2p.shape[1]
    if m is None or m < 1:
        return kops.default_select_seed(d2p, T)
    samp = d2p[:, :: max(n // 4096, 1)]
    scale = samp.mean(1) / float(m)  # Lemma-2 r̄² estimate
    q = min(max(T / n, 1e-6), 1.0 - 1e-9)
    return scale * float(chi2_ppf(q, m))


def fused_ann_query(index: FlatIndex, q: torch.Tensor, *, k: int, T: int,
                    force: str | None = None, with_count: bool = False):
    """(c,k)-ANN through the fused pipeline.

    Same contract as ``flat_index.ann_query``: (indices (B, k) int32,
    distances (B, k) float32), and the same output on ties-free data.
    The select hands verify the T candidates as a set: on the card in
    ascending id order (the CUDA select's own, with no sort after it),
    on the plain route ascending by estimate; verify breaks an exact
    distance tie by candidate position, so only such ties can answer
    differently on the two routes.

    While tracing, each stage runs under an ``ann.*`` span (the
    ``kernel.*`` spans of ``kernels.ops`` nest underneath) with its
    outputs synchronized before the span closes, and the select span
    records the batch's summed survivor count as
    ``candidates_selected`` (a host read, only while tracing).  With
    tracing off a span is a shared no-op and nothing synchronizes.

    Args:
      q: (B, d) query batch on the index's device.
      k: results per query (the kernel answers k ≤ 128; larger k takes
        the plain verify, as the reference routes it).
      T: candidate budget (βn + k) from ``candidate_budget``.
      force: kernel dispatch override (None or "plain").
      with_count: also return the select stage's per-query survivor
        counts (B,) int32 — realized T, the signal behind
        ``WorkStats.candidates_selected``.
    """
    q = q.to(torch.float32)
    if q.ndim == 1:
        q = q[None]
    with otrace.span("ann.query", B=int(q.shape[0]), n=int(index.data.shape[0]),
                     k=k, T=T):
        with otrace.span("ann.project"):
            qp = otrace.block(index.family.project(q))  # (B, m)

        # 1. estimate: projected squared distances (Lemma 2)
        with otrace.span("ann.estimate"):
            d2p = kops.pairwise_sq_dist(qp, index.projected, force=force)  # (B, n)

        # 2. select: radius-threshold selection seeded from Eq. 9
        with otrace.span("ann.select") as sp:
            m = index.params.m if index.params is not None else index.m
            tau0 = select_seed(d2p, T, m)
            # verify reads only the set: no sort after the select
            _, cand, cnt = kops.radius_select(d2p, T, tau0=tau0, force=force,
                                              with_count=True, ordered=False)  # (B, T), (B,)
            if sp is not None:
                sp.attrs["candidates_selected"] = int(cnt.sum())

        # 3-4. verify + answer: gather-free exact distances, top-k
        with otrace.span("ann.verify"):
            d2, idx = kops.verify_topk(index.data, q, cand, k, force=force)
        with otrace.span("ann.answer"):
            out = otrace.block(idx, torch.sqrt(torch.clamp_min(d2, 0.0)))
    return out + (cnt,) if with_count else out
