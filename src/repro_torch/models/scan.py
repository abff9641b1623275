"""The linear-recurrence scan of the recurrent blocks, the port of
``jax.lax.associative_scan`` for the combine

    (a1, b1), (a2, b2) → (a2·a1, a2·b1 + b2)

along one axis, so ``h_t = a_t·h_{t−1} + b_t`` from h_{−1} = 0 comes out
as the second tensor.

It is the reference's odd/even recursion (Blelloch's): combine adjacent
pairs, scan the half-length sequence recursively, fill in the even
positions from the odd ones and interleave.  The same recursion makes
the same float associations as the reference, so float32 agrees to an
ulp or so per level, and it is log-depth: a sequence of S steps is
≈ 2·log2(S) rounds of elementwise launches, not S.
"""
from __future__ import annotations

import torch

__all__ = ["linear_scan"]


def _combine(x: tuple, y: tuple) -> tuple:
    a1, b1 = x
    a2, b2 = y
    return a2 * a1, a2 * b1 + b2


def _slice(t: torch.Tensor, dim: int, start: int, stop: int | None, step: int = 1):
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> tuple:
    n = a.shape[dim]
    if n < 2:
        return a, b
    reduced = _combine((_slice(a, dim, 0, n - 1, 2), _slice(b, dim, 0, n - 1, 2)),
                       (_slice(a, dim, 1, None, 2), _slice(b, dim, 1, None, 2)))
    odd_a, odd_b = _scan(*reduced, dim)
    rest = (_slice(a, dim, 2, None, 2), _slice(b, dim, 2, None, 2))
    if n % 2 == 0:
        ev_a, ev_b = _combine((_slice(odd_a, dim, 0, -1), _slice(odd_b, dim, 0, -1)), rest)
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), rest)
    ev_a = torch.cat([_slice(a, dim, 0, 1), ev_a], dim=dim)
    ev_b = torch.cat([_slice(b, dim, 0, 1), ev_b], dim=dim)
    return _interleave(ev_a, odd_a, dim), _interleave(ev_b, odd_b, dim)


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1) -> tuple:
    """The inclusive prefix of ``(a, b)`` under the linear-recurrence
    combine along ``dim``: returns (∏ a up to t, h_t) with
    ``h_t = a_t·h_{t−1} + b_t``.  ``a`` and ``b`` have one shape."""
    if a.shape != b.shape:
        raise ValueError(f"linear_scan: a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    return _scan(a, b, dim % a.ndim)
