"""Dispatch over the port's kernels, mirroring ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
plain PyTorch version in ``ref``.  ``force="plain"`` takes the plain
version on any device: it exists for the tests and for ``chip_smoke.py``,
which holds each kernel against it on the card.  There is no interpret
mode and no fallback: a kernel that fails to build or launch raises.

Observability: while ``repro_torch.obs`` tracing is enabled, every
dispatch records a ``kernel.<op>`` span carrying the op's modeled
bytes/FLOPs (``repro_torch.obs.roofline``, the reference's models),
opened after its inputs and closed after its outputs are synchronized
(``obs.trace.block``), so a trace places each kernel on the roofline.
Where the card's kernel does less work than the a-priori model counts,
its span is refined from what the call did, as the reference refines
pair_join's from its ``tiles_pruned``: radius_select from its kernel's
4 reads of d, verify_topk from the rows its distance pass read.
Disabled cost is one boolean check and one profiler check per call and
no host sync.  With tracing off under a ``torch.profiler`` the span is a
profiler range of the same name, with no model and no sync.  verify's topk launch
(from C) and radius_select's sorts run inside their caller's span and
open none of their own, as in the reference; on the plain route the
select's overflow check, its one host read, runs in a port-only
``sync.select_overflow`` span.  The CUDA select reads nothing back.
"""
from __future__ import annotations

import functools

import torch

from ..obs import roofline as _roofline
from ..obs import trace as _otrace
from . import adc as _adc
from . import counts, ref
from . import pair_join as _pair_join
from . import pairwise_dist as _pairwise
from . import project_dist as _project
from . import select as _select
from . import topk as _topk
from . import verify as _verify

__all__ = ["pairwise_sq_dist", "project_dist", "topk_smallest",
           "default_select_seed", "radius_select", "verify_topk", "adc_dist",
           "pair_join"]

#: reads of d the CUDA select makes: the ladder, two histogram passes
#: (7 bisection steps each), the compaction
SELECT_KERNEL_PASSES = 4


def _plain(force: str | None, *tensors: torch.Tensor) -> bool:
    """True where the plain version answers: forced, or CPU tensors."""
    if force not in (None, "plain"):
        raise ValueError(f"force must be None or 'plain', got {force!r}")
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on several devices: {sorted(kinds)}")
    return force == "plain" or kinds == {"cpu"}


def _instrumented(name: str, cost_of):
    """Wrap a dispatch in a roofline-annotated kernel span while tracing.

    ``cost_of(*args, **kw)`` returns the op's :class:`KernelCost` for the
    call's shapes.  The inputs are synchronized before the span opens,
    so work queued ahead of the call (a gather of its operand) stays out
    of it, and the span closes after ``block`` so the card's work lands
    inside it."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _otrace.enabled():
                with _otrace.span(name):  # a profiler range where one runs
                    return fn(*args, **kw)
            _otrace.block(args, tuple(kw.values()))
            with _otrace.get_tracer().span(name, **cost_of(*args, **kw).attrs()):
                out = fn(*args, **kw)
                _otrace.block(out)
            return out

        return wrapper

    return deco


def _refine(name: str, cost: _roofline.KernelCost, **extra) -> None:
    """Replace the open ``name`` span's model by this call's realized cost."""
    sp = _otrace.current_span()
    if sp is not None and sp.name == name:
        sp.attrs.update(cost.attrs())
        sp.attrs.update(extra)


def _pairwise_cost(q, x, **kw) -> _roofline.KernelCost:
    if x.ndim == 3:
        B, N, d = x.shape
    else:
        (B, d), N = q.shape, x.shape[0]
    return _roofline.pairwise_sq_dist_cost(B, N, d)


def _project_cost(x, a, qp, **kw) -> _roofline.KernelCost:
    return _roofline.project_dist_cost(x.shape[0], x.shape[1], a.shape[1],
                                       qp.shape[0])


def _adc_cost(codes, lut, **kw) -> _roofline.KernelCost:
    B, S, V = lut.shape
    return _roofline.adc_dist_cost(B, codes.shape[-2], S, V)


def _topk_cost(d, k, **kw) -> _roofline.KernelCost:
    return _roofline.topk_cost(d.shape[0], d.shape[1], k)


def _select_T_pad(N: int, T: int, T_pad: int | None) -> int:
    if T_pad is None:
        T_pad = T + max(256, T // 8)
    return min(max(T_pad, T), N)


def _select_cost(d, T, *, T_pad=None, **kw) -> _roofline.KernelCost:
    B, N = d.shape
    return _roofline.radius_select_cost(B, N, _select_T_pad(N, T, T_pad))


def _verify_cost(data, q, cand, k, **kw) -> _roofline.KernelCost:
    B, Tc = cand.shape
    return _roofline.verify_topk_cost(B, Tc, data.shape[1], k)


def _pair_join_cost(x, key, k, **kw) -> _roofline.KernelCost:
    n, d = x.shape
    return _roofline.pair_join_cost(n, d, k)


@_instrumented("kernel.pairwise_sq_dist", _pairwise_cost)
def pairwise_sq_dist(q: torch.Tensor, x: torch.Tensor, *,
                     force: str | None = None) -> torch.Tensor:
    """(B,d) × (N,d) → (B,N) squared Euclidean distances (float32).

    x may be per-query candidate rows (B, N, d), the gathered VERIFY
    form, which sums in the difference form.
    """
    if _plain(force, q, x):
        return ref.pairwise_sq_dist(q, x)
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    if x.ndim == 3:
        return _pairwise.pairwise_sq_dist_rows(q, x)
    return _pairwise.pairwise_sq_dist(q, x)


@_instrumented("kernel.project_dist", _project_cost)
def project_dist(x: torch.Tensor, a: torch.Tensor, qp: torch.Tensor, *,
                 force: str | None = None) -> torch.Tensor:
    """Fused (x @ a) projected distances to qp: (N, d), (d, m), (B, m) →
    (B, N) squared distances, the projection never written out."""
    if _plain(force, x, a, qp):
        return ref.project_dist(x, a, qp)
    return _project.project_dist(x.to(torch.float32).contiguous(),
                                 a.to(torch.float32).contiguous(),
                                 qp.to(torch.float32).contiguous())


@_instrumented("kernel.topk_smallest", _topk_cost)
def topk_smallest(d: torch.Tensor, k: int, *, force: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest (values, indices int32) of d (B, N), ascending,
    ties to the lowest index.

    k > 128 is past the kernel's width and answers through
    ``radius_select``, on any device, as the reference routes it
    (ops.py:180-181).
    """
    N = d.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"topk_smallest: k={k} out of range for N={N}")
    if k > _topk.MAX_K:
        counts.route("topk_smallest.k_over_128")
        return radius_select(d, k, force=force)
    if _plain(force, d):
        return ref.topk_smallest(d, k)
    return _topk.topk_smallest(d.to(torch.float32).contiguous(), k)


def default_select_seed(d: torch.Tensor, T: int, *, stride: int = 8) -> torch.Tensor:
    """Per-row seed for radius selection from a strided sample of d:
    the sample mean scaled by the target fraction T/N — within the
    rung ladder's reach of the T-th smallest for any unimodal row."""
    samp = d[:, ::stride]
    N = d.shape[1]
    return samp.mean(1) * max(T / N, 1e-3)


@_instrumented("kernel.radius_select", _select_cost)
def radius_select(d: torch.Tensor, T: int, *, tau0: torch.Tensor | None = None,
                  T_pad: int | None = None, force: str | None = None,
                  with_count: bool = False, ordered: bool = True):
    """Row-wise T smallest (values, indices) by radius thresholding, ties
    to the lowest index.

    On a CUDA tensor the kernel answers each row's first T by (value,
    index) itself, in ascending index order, with no host read; a caller
    that reads the order (``ordered=True``, the default) gets them
    ascending by a stable sort over the T, a caller that needs only the
    set (``ordered=False``) gets the kernel's index order.  Traced, the
    span records the batch's summed final band (``band``) and the rows
    resolved over the whole row (``band_fallback_rows``): a host read,
    only while tracing.

    The plain route (CPU tensors, ``force="plain"``) is the reference's:
    the kernel compacts the survivors of a threshold into T_pad ≥ T slots
    and one stable sort over those finishes, ascending whatever
    ``ordered`` says.  A tie cluster wider than the buffer is detected
    from the exact survivor counts and rerouted to the exact sort: that
    check reads the counts on the host.  On every device a degenerate
    budget (T_pad ≥ N) sorts directly.

    ``with_count=True`` appends the per-row survivor count (B,) int32
    (``WorkStats.candidates_selected``); the sort paths report T.
    """
    B, N = d.shape
    if not 1 <= T <= N:
        raise ValueError(f"radius_select: T={T} out of range for N={N}")
    T_pad = _select_T_pad(N, T, T_pad)
    plain = _plain(force, d)

    def _sort():
        vals, idx = ref.topk_smallest(d, T)
        return vals, idx, torch.full((B,), T, dtype=torch.int32, device=d.device)

    if T_pad >= N:  # nothing to skip: the plain sort is cheaper
        counts.route("radius_select.sort")
        vals, idx, cnt = _sort()
        return (vals, idx, cnt) if with_count else (vals, idx)
    if tau0 is None:
        tau0 = default_select_seed(d, T)
    d32 = d.to(torch.float32).contiguous()
    if not plain:
        vals, idx, cnt, stats = _select.radius_select(d32, tau0, T, stats=True)
        band = {}
        if _otrace.enabled():  # the one host read, only while tracing
            total, _, fallback = stats.sum(0).tolist()
            band = {"band": total, "band_fallback_rows": fallback}
        _refine("kernel.radius_select", _roofline.radius_select_cost(
            B, N, T, passes=SELECT_KERNEL_PASSES), passes=SELECT_KERNEL_PASSES, **band)
        if ordered:
            vals, pos = ref.topk_smallest(vals, T)
            idx = torch.gather(idx, 1, pos.to(torch.int64))
    else:
        vals_p, idx_p, cnt = ref.radius_select_kernel(d32, tau0, T, T_pad=T_pad)
        # an overflowed buffer dropped survivors in index order, possibly
        # true top-T members: answer with the exact sort instead
        with _otrace.span("sync.select_overflow"):
            overflow = bool((cnt > T_pad).any())
        if overflow:
            counts.route("radius_select.overflow")
            vals, idx, cnt = _sort()
        else:
            vals, pos = ref.topk_smallest(vals_p, T)
            idx = torch.gather(idx_p, 1, pos.to(torch.int64))
    return (vals, idx, cnt) if with_count else (vals, idx)


@_instrumented("kernel.verify_topk", _verify_cost)
def verify_topk(data: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, k: int, *,
                force: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused VERIFY: exact distances on candidate ids + top-k answer.

    data (n,d) × q (B,d) × cand (B,Tc) → (d² (B,k) ascending, ids (B,k)).
    k > 128 is past the kernel's answer width and takes the plain
    version on every device, as the reference routes it (ops.py:309).
    """
    if k > _verify.MAX_K:
        counts.route("verify_topk.k_over_128")
        return ref.verify_topk(data, q, cand, k)
    if _plain(force, data, q, cand):
        return ref.verify_topk(data, q, cand, k)
    vals, ids, rows = _verify.verify_topk(
        data.to(torch.float32).contiguous(), q.to(torch.float32).contiguous(),
        cand.to(torch.int32).contiguous(), k, rows_read=True)
    if _otrace.enabled():  # the one host read, only while tracing
        B, Tc = cand.shape
        rows_read = int(rows.item())
        _refine("kernel.verify_topk", _roofline.verify_topk_cost(
            B, Tc, data.shape[1], k, rows_read=rows_read), rows_read=rows_read)
    return vals, ids


@_instrumented("kernel.adc_dist", _adc_cost)
def adc_dist(codes: torch.Tensor, lut: torch.Tensor, *,
             force: str | None = None) -> torch.Tensor:
    """Asymmetric distances: codes (N, S) or per-query (B, N, S) × LUTs
    (B, S, V) → (B, N).  The kernel reads the codes as uint8."""
    if _plain(force, codes, lut):
        return ref.adc_dist(codes, lut)
    return _adc.adc_dist(codes.to(torch.uint8).contiguous(),
                         lut.to(torch.float32).contiguous())


@_instrumented("kernel.pair_join", _pair_join_cost)
def pair_join(x: torch.Tensor, key: torch.Tensor, k: int, *, thresh2: float,
              force: str | None = None):
    """Top-k closest pairs of x's rows by pruned blockwise self-join.

    x (n, d) sorted ascending by key (n,) → (d² (k,) ascending, pi (k,),
    pj (k,), stats (3,) int64 = [pairs_verified, tiles_pruned,
    bands_joined]); pi < pj are row POSITIONS in the sorted order,
    (+inf, −1, −1) past the real pair count.  ``thresh2`` = (γ·t)² is
    Algorithm 4's radius filter as tile masking; ``float('inf')``
    disables pruning.  k > 128 is past the kernel's pair heap and takes
    the plain version on every device, as the reference routes it
    (ops.py:268).

    The CUDA kernel is bound by float32 multiply-adds on CUDA cores (2·d
    flops a verified pair).  Where the TPU kernel walks its tiles in one
    serial grid, it runs the sweep as one cooperative launch: groups of
    bands whose candidate tiles the whole card joins under the group's
    first ub², each folded in order by one warp, 32 tiles a ballot, with
    no read back to the host.

    Traced, its span's model is refined post-hoc from the join's own
    ``tiles_pruned`` counter (its traffic is data-dependent), as the
    reference's is.
    """
    if k > _pair_join.MAX_K:
        counts.route("pair_join.k_over_128")
        out = ref.pair_join(x, key, k, thresh2=thresh2)
    elif _plain(force, x, key):
        out = ref.pair_join(x, key, k, thresh2=thresh2)
    else:
        out = _pair_join.pair_join(x.to(torch.float32).contiguous(),
                                   key.to(torch.float32).contiguous(), k,
                                   thresh2=float(thresh2))
    if _otrace.enabled():  # a host read of the counter, only while tracing
        n, d = x.shape
        n_ti = max(-(-n // 128), 1)
        pruned = int(out[3][1])
        _refine("kernel.pair_join", _roofline.pair_join_cost(
            n, d, k, tiles_visited=n_ti * (n_ti + 1) // 2 - pruned),
            tiles_pruned=pruned)
    return out
