"""Launch counts of the port's CUDA kernels, and of the plain routes.

Each kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel, and nowhere else, so a run can show which kernels
its path went through: ``reset()``, drive the path, ``snapshot()``.
``ROUTES`` counts the dispatch rules of ``ops`` that take another way
than the call's own kernel (the reference's own routing, not a
fallback): the degenerate-budget sort and the overflow reroute of
``radius_select``, ``verify_topk`` and ``pair_join`` at k > 128 (their
plain versions, on any device), and ``topk_smallest`` at k > 128, which
answers through ``radius_select``.
"""
from __future__ import annotations

__all__ = ["LAUNCHES", "ROUTES", "bump", "route", "reset", "snapshot"]

LAUNCHES: dict[str, int] = {
    "pairwise_sq_dist": 0,       # 2-D form, norm trick
    "pairwise_sq_dist_rows": 0,  # per-query (B, N, d) form, difference form
    "radius_select": 0,          # one count per call: 4 CUDA launches and a memset
    "verify_topk": 0,            # one count per call: counting sort, distances, topk
    "adc_dist": 0,               # one count per call: one launch
    "pair_join": 0,              # one count per call: one cooperative launch
    "topk_smallest": 0,          # one count per call: one launch, or two (splits + merge)
    "project_dist": 0,           # one count per call: one launch
}

ROUTES: dict[str, int] = {
    "radius_select.sort": 0,       # T_pad >= N: nothing to skip
    "radius_select.overflow": 0,   # survivors > T_pad: exact sort instead
    "verify_topk.k_over_128": 0,   # beyond the kernel's answer width
    "pair_join.k_over_128": 0,     # beyond the kernel's pair heap
    "topk_smallest.k_over_128": 0,  # beyond the kernel's k: radius_select
}


def bump(name: str) -> None:
    LAUNCHES[name] += 1


def route(name: str) -> None:
    ROUTES[name] += 1


def reset() -> None:
    for table in (LAUNCHES, ROUTES):
        for key in table:
            table[key] = 0


def snapshot() -> dict[str, dict[str, int]]:
    return {"launches": dict(LAUNCHES), "routes": dict(ROUTES)}
