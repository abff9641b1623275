"""Roofline models: modeled bytes + FLOPs per kernel dispatch (the port's
copy of ``repro.obs.roofline``).

Every kernel span records the bytes the op must move and the FLOPs it
must execute for its argument shapes, so a trace pairs each measured
duration with its model and answers *memory-bound or compute-bound,
and at what fraction of peak*.  The per-kernel models are the
reference's, unchanged: a span says what work the op does, whatever
implements it.  Where the work depends on the data, the caller passes
what this call did: pair_join its tiles visited (the reference's own
post-hoc refinement), and — an argument the reference's models lack,
defaulting to their a-priori count — radius_select the reads of d its
kernel made and verify_topk the candidate rows it read.

Conventions:

  * bytes are the minimal one-pass traffic of the op at float32 (code
    arrays at their stored width) — reads of every input once, writes
    of every output once.  Kernels that re-read (the radius-select
    ladder) model their pass count explicitly.
  * FLOPs count multiply and add separately (one MAC = 2 FLOPs),
    compares/selects count 1 — the usual roofline convention.
  * arithmetic intensity AI = flops / bytes.  Against a device's
    (peak_flops, peak_bw) the ridge point is peak_flops / peak_bw;
    AI below the ridge → the op is memory-bound, its attainable
    ceiling is AI · peak_bw; above → compute-bound at peak_flops.

Peaks are keyed on the torch device kind: ``"cuda"`` is the NVIDIA
H100 80GB HBM3 (its data sheet's HBM3 rate and its float32 rate outside
the tensor cores, where the port's kernels do their arithmetic),
``"cpu"`` a rough server slice.  :func:`set_peaks` pins measured peaks
for a process.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KernelCost", "DevicePeaks", "device_kind", "get_peaks",
           "set_peaks", "pairwise_sq_dist_cost", "project_dist_cost",
           "adc_dist_cost", "topk_cost", "radius_select_cost",
           "verify_topk_cost", "pair_join_cost", "shard_exchange_cost",
           "shard_merge_cost", "shard_ring_cost", "achieved"]

F32 = 4


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Modeled single-execution cost of one kernel dispatch."""

    bytes: int
    flops: int

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per byte moved)."""
        return self.flops / max(self.bytes, 1)

    def attrs(self) -> dict:
        """The span-attribute form kernel instrumentation records."""
        return {"bytes": int(self.bytes), "flops": int(self.flops),
                "intensity": round(self.intensity, 4)}


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Nominal (peak FLOP/s, peak bytes/s) for classification."""

    kind: str
    peak_flops: float
    peak_bw: float
    name: str = ""

    @property
    def ridge(self) -> float:
        """AI at which the roofline transitions memory→compute bound."""
        return self.peak_flops / self.peak_bw


_DEFAULT_PEAKS = {
    # ~8-core AVX2 server slice: 8c · 2.5GHz · 16 f32 FLOP/cycle; DDR4
    "cpu": DevicePeaks("cpu", 3.2e11, 4.0e10, "cpu"),
    # NVIDIA H100 80GB HBM3 (SXM) data sheet: the float32 rate outside
    # the tensor cores, where the port's kernels compute, and HBM3's rate
    "cuda": DevicePeaks("cuda", 6.7e13, 3.35e12, "NVIDIA H100 80GB HBM3"),
}
_PEAKS_OVERRIDE: DevicePeaks | None = None


def device_kind(device: str | torch.device | None = None) -> str:
    """The torch device kind ("cuda" | "cpu"): of ``device`` when given,
    else "cuda" where a card is present."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def get_peaks(kind: str | None = None) -> DevicePeaks:
    if _PEAKS_OVERRIDE is not None:
        return _PEAKS_OVERRIDE
    kind = kind or device_kind()
    return _DEFAULT_PEAKS.get(kind, _DEFAULT_PEAKS["cpu"])


def set_peaks(peaks: DevicePeaks | None) -> None:
    """Pin measured peaks for this process (None restores defaults)."""
    global _PEAKS_OVERRIDE
    _PEAKS_OVERRIDE = peaks


# ---------------------------------------------------------------------------
# per-kernel models (shapes as the ops-layer sees them)
# ---------------------------------------------------------------------------


def pairwise_sq_dist_cost(B: int, N: int, d: int) -> KernelCost:
    """ESTIMATE: (B,d)×(N,d)→(B,N).  One read of each input, one write
    of the output; 2·B·N·d MACs-worth of FLOPs (norm trick or direct
    difference cost the same to leading order)."""
    return KernelCost(bytes=(B * d + N * d + B * N) * F32,
                      flops=2 * B * N * d + 2 * B * N)


def project_dist_cost(N: int, d: int, m: int, B: int) -> KernelCost:
    """Fused project+distance: x (N,d) @ a (d,m), then (B,m)×(N,m)."""
    proj = KernelCost(bytes=(N * d + d * m) * F32, flops=2 * N * d * m)
    dist = pairwise_sq_dist_cost(B, N, m)
    return KernelCost(bytes=proj.bytes + dist.bytes,
                      flops=proj.flops + dist.flops)


def adc_dist_cost(B: int, N: int, S: int, V: int,
                  code_bytes: int = 1) -> KernelCost:
    """ADC rerank: codes (N,S) or (B,N,S) at 1 byte/slot + LUTs
    (B,S,V) f32 read once; one gather+add per (b, n, s)."""
    return KernelCost(bytes=B * N * S * code_bytes + B * S * V * F32
                      + B * N * F32,
                      flops=2 * B * N * S)


def topk_cost(B: int, N: int, k: int) -> KernelCost:
    """Selection-network top-k: one read of (B,N); ~N·k compares/row."""
    return KernelCost(bytes=(B * N + 2 * B * k) * F32, flops=B * N * k)


def radius_select_cost(B: int, N: int, T_pad: int,
                       passes: int = 16) -> KernelCost:
    """SELECT: the threshold ladder re-reads the (B,N) row once per
    counting pass (ladder + bisection + compaction ≈ ``passes``), then
    writes the compacted (B, T_pad) values + indices.  The H100 kernel
    reads d 4 times (the ladder, two histogram passes, the compaction);
    its dispatch passes that count."""
    return KernelCost(bytes=passes * B * N * F32 + 2 * B * T_pad * F32,
                      flops=passes * B * N)


def verify_topk_cost(B: int, Tc: int, d: int, k: int,
                     rows_read: int | None = None) -> KernelCost:
    """Gather-free VERIFY: each candidate row read once (B·Tc·d reads),
    queries once, (B,k)·2 answer writes; exact distances are 2·B·Tc·d
    FLOPs plus the streaming top-k compares.  ``rows_read`` replaces the
    B·Tc candidate rows read where the kernel read fewer: the H100
    kernel reads each distinct row once per group of queries (up to 512
    queries past d = 512, as many as fit 8 MiB of the L2) and reports how
    many it read."""
    rows = B * Tc if rows_read is None else max(int(rows_read), 0)
    return KernelCost(bytes=(rows * d + B * d + 4 * B * k) * F32,
                      flops=2 * B * Tc * d + B * Tc * k)


def pair_join_cost(n: int, d: int, k: int, block_n: int = 128,
                   tiles_visited: int | None = None) -> KernelCost:
    """CP JOIN: band-major sweep over the upper-triangular tile space.
    Each *visited* tile reads two (block_n, d) row blocks and verifies
    block_n² pairs; ``tiles_visited`` defaults to the full triangle
    (the a-priori model — pruning is data-dependent, so post-hoc
    callers pass the kernel's realized ``tiles_pruned`` subtracted)."""
    n_ti = max(-(-n // block_n), 1)
    total_tiles = n_ti * (n_ti + 1) // 2
    tiles = total_tiles if tiles_visited is None else max(tiles_visited, 0)
    return KernelCost(
        bytes=tiles * 2 * block_n * d * F32 + 4 * k * F32,
        flops=tiles * (2 * block_n * block_n * d + block_n * block_n * k))


def shard_exchange_cost(P: int, B: int, k_l: int, rounds: int = 32) -> KernelCost:
    """Sharded-ANN THRESHOLD EXCHANGE: the counts-only bisection.  Each
    of the ``rounds`` rungs psums one (B,) int32 survivor count per
    shard, ``rounds·P·B`` int32 on the wire and no candidate payload;
    the FLOPs are the reduction's P·B adds a rung.  (``k_l`` is carried
    so callers can log the companion merge volume beside it; it does
    not enter this cost.)"""
    del k_l
    return KernelCost(bytes=rounds * P * B * 4, flops=rounds * P * B)


def shard_merge_cost(P: int, B: int, k_l: int) -> KernelCost:
    """All-gather-of-k MERGE: each shard contributes (B, k_l) float32
    distances and int32 ids, a pool of P·B·k_l·8 bytes; the selection
    over it is modelled linear, P·B·k_l compares."""
    return KernelCost(bytes=P * B * k_l * (F32 + 4), flops=P * B * k_l)


def shard_ring_cost(P: int, nl: int, d: int, k: int) -> KernelCost:
    """One CP ring hop: every shard passes its (nl, d) row block, (nl,)
    norms, keys and ids to its neighbour, and the round's ub refresh
    all-gathers each shard's (k,) running best."""
    return KernelCost(bytes=P * (nl * d * F32 + 3 * nl * F32 + k * F32),
                      flops=P * nl * d)


# ---------------------------------------------------------------------------
# achieved performance: model + measured time → roofline placement
# ---------------------------------------------------------------------------


def achieved(cost: KernelCost, seconds: float,
             peaks: DevicePeaks | None = None) -> dict:
    """Place one measured execution on the roofline.

    Returns the span-attribute dict the exporter merges into kernel
    spans: achieved GFLOP/s and GB/s, the model's arithmetic
    intensity, the bound classification against ``peaks`` (memory if
    AI < ridge else compute) and the fraction of the *attainable*
    ceiling (min(peak_flops, AI·peak_bw)) the execution reached."""
    peaks = peaks or get_peaks()
    t = max(float(seconds), 1e-12)
    gflops = cost.flops / t / 1e9
    gbps = cost.bytes / t / 1e9
    ai = cost.intensity
    ceiling = min(peaks.peak_flops, ai * peaks.peak_bw)
    return {
        "achieved_gflops": round(gflops, 3),
        "achieved_gbps": round(gbps, 3),
        "intensity": round(ai, 4),
        "ridge": round(peaks.ridge, 4),
        "bound": "memory" if ai < peaks.ridge else "compute",
        "fraction_of_peak": round(cost.flops / t / max(ceiling, 1.0), 6),
        "device_kind": peaks.kind,
    }
