"""Quantization codecs: compressed point storage and ADC lookup tables,
the counterpart of ``repro.quant.codec``.

Both codecs reduce to the ADC kernel's (codes, LUT) form
(``repro_torch.kernels.adc``): a point is S uint8 code slots with values
in [0, V); a query becomes a (S, V) table of squared per-slot distance
contributions; the asymmetric distance is the sum of S table entries.

  SQ8 — scalar int8: one slot per dimension, the 256 values an affine
        grid over that dimension's [min, max] range.
  PQ  — product quantization: one slot per sub-codebook (d split into
        ``m_codebooks`` contiguous subspaces, zero-padded), the values
        k-means centroids trained at build time.

Training is numpy on the host, copied from the reference so the same
seed gives bit-identical grids and centroids; the codecs hold tensors
on the index's device, and ``encode`` / ``decode`` / ``lookup_tables``
/ ``adc_direct`` work on tensors there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, resolve_device

__all__ = ["SQ8Codec", "PQCodec", "train_codec", "train_sq8", "train_pq"]


def _f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return as_tensor(x, device)


@dataclasses.dataclass(frozen=True)
class SQ8Codec:
    """Scalar quantizer: dim j's code v decodes to offset[j] + v·scale[j]."""

    scale: torch.Tensor  # (d,) float32, grid step per dimension (> 0)
    offset: torch.Tensor  # (d,) float32, grid origin per dimension

    V = 256

    @property
    def n_slots(self) -> int:
        return self.scale.shape[0]

    @property
    def n_values(self) -> int:
        return self.V

    @property
    def bytes_per_point(self) -> float:
        return float(self.n_slots)  # 1 byte/dim; scale/offset are O(d) total

    def encode(self, x) -> torch.Tensor:
        """(N, d) float → (N, d) uint8 codes."""
        x = _f32(x, self.scale.device)
        v = torch.round((x - self.offset[None, :]) / self.scale[None, :])
        return torch.clamp(v, 0, self.V - 1).to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.offset[None, :] + codes.to(torch.float32) * self.scale[None, :]

    def lookup_tables(self, q) -> torch.Tensor:
        """(B, d) queries → (B, d, V) float32 tables."""
        q = _f32(q, self.scale.device)
        grid = self.offset[:, None] + self.scale[:, None] * torch.arange(
            self.V, dtype=torch.float32, device=q.device)  # (d, V)
        return (q[:, :, None] - grid[None]) ** 2

    def adc_direct(self, q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """ADC without tables (SQ8 decoding is affine): q (B, d) × codes
        (B, T, d) → (B, T) squared distances, plain PyTorch as the
        reference's is plain jnp."""
        dec = (self.offset[None, None, :]
               + codes.to(torch.float32) * self.scale[None, None, :])
        return ((dec - q[:, None, :]) ** 2).sum(-1)


def train_sq8(x: np.ndarray, *, device: str | torch.device = "cuda",
              **_ignored) -> SQ8Codec:
    """Fit the per-dimension [min, max] grid (one pass, no iterations)."""
    x = np.asarray(x, np.float32)
    lo, hi = x.min(axis=0), x.max(axis=0)
    scale = np.maximum((hi - lo) / (SQ8Codec.V - 1), 1e-12).astype(np.float32)
    dev = resolve_device(device)
    return SQ8Codec(scale=as_tensor(scale, dev), offset=as_tensor(lo, dev))


@dataclasses.dataclass(frozen=True)
class PQCodec:
    """Product quantizer: slot s's code v decodes to centroids[s, v].

    ``centroids`` work on the zero-padded dimensionality S·ds ≥ d; ``d``
    trims the padding off in decode.
    """

    centroids: torch.Tensor  # (S, V, ds) float32
    d: int  # original dimensionality (≤ S·ds)

    @property
    def n_slots(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_values(self) -> int:
        return self.centroids.shape[1]

    @property
    def sub_dim(self) -> int:
        return self.centroids.shape[2]

    @property
    def bytes_per_point(self) -> float:
        return float(self.n_slots)  # 1 byte/slot (V ≤ 256); codebooks O(1)

    @property
    def codebook_bytes(self) -> int:
        return self.centroids.numel() * 4

    def _split(self, x) -> torch.Tensor:
        """(N, d) → (N, S, ds), zero-padding the trailing dims."""
        x = _f32(x, self.centroids.device)
        dp = self.n_slots * self.sub_dim
        x = torch.nn.functional.pad(x, (0, dp - x.shape[1]))
        return x.reshape(x.shape[0], self.n_slots, self.sub_dim)

    def encode(self, x) -> torch.Tensor:
        """(N, d) float → (N, S) uint8: per slot, the argmin over an
        (N, V) dot expansion (the reference's form, never the (N, S, V,
        ds) difference tensor)."""
        sub = self._split(x)
        cn = (self.centroids * self.centroids).sum(-1)  # (S, V)
        codes = [torch.argmin(cn[s][None, :] - 2.0 * (sub[:, s, :] @ self.centroids[s].T),
                              dim=-1)
                 for s in range(self.n_slots)]
        return torch.stack(codes, dim=1).to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        codes = codes.to(torch.int64)  # (N, S)
        slots = torch.arange(self.n_slots, device=codes.device)[None, :]
        sub = self.centroids[slots, codes]  # (N, S, ds)
        return sub.reshape(codes.shape[0], -1)[:, : self.d]

    def lookup_tables(self, q) -> torch.Tensor:
        """(B, d) queries → (B, S, V) float32 tables."""
        qsub = self._split(q)
        return ((qsub[:, :, None, :] - self.centroids[None]) ** 2).sum(-1)


def train_pq(
    x: np.ndarray,
    m_codebooks: int = 16,
    n_values: int = 256,
    iters: int = 10,
    sample: int = 16384,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
    **_ignored,
) -> PQCodec:
    """Per-subspace Lloyd k-means on (a sample of) the data, numpy with
    ``default_rng(seed)`` as in the reference.

    d is zero-padded up to a multiple of ``m_codebooks``; V is clamped
    to min(n_values, n/2, 256).  Empty clusters are reseeded from the
    rows farthest from their centroid.
    """
    x = np.asarray(x, np.float32)
    n, d = x.shape
    S = max(1, min(int(m_codebooks), d))
    V = max(1, min(int(n_values), n // 2, 256))
    rng = np.random.default_rng(seed)
    if n > sample:
        x = x[rng.choice(n, sample, replace=False)]
        n = sample
    ds = -(-d // S)  # ceil
    xp = np.zeros((n, S * ds), np.float32)
    xp[:, :d] = x
    sub = xp.reshape(n, S, ds)

    cents = np.empty((S, V, ds), np.float32)
    for s in range(S):
        pts = sub[:, s, :]  # (n, ds)
        c = pts[rng.choice(n, V, replace=(n < V))].copy()
        for _ in range(max(1, iters)):
            d2 = (
                np.sum(pts * pts, axis=1, keepdims=True)
                + np.sum(c * c, axis=1)[None, :]
                - 2.0 * pts @ c.T
            )  # (n, V)
            assign = np.argmin(d2, axis=1)
            counts = np.bincount(assign, minlength=V)
            sums = np.zeros((V, ds), np.float32)
            np.add.at(sums, assign, pts)
            nonempty = counts > 0
            c[nonempty] = sums[nonempty] / counts[nonempty, None]
            empties = np.flatnonzero(~nonempty)
            if empties.size:  # reseed from the worst-fit rows
                worst = np.argsort(-d2[np.arange(n), assign])[: empties.size]
                c[empties] = pts[worst]
        cents[s] = c
    return PQCodec(centroids=as_tensor(cents, resolve_device(device)), d=d)


_TRAINERS = {"sq8": train_sq8, "pq": train_pq}


def train_codec(name: str, x: np.ndarray, *, seed: int = 0,
                device: str | torch.device = "cuda", **opts):
    """Train the codec registered under ``name`` ("sq8" | "pq") on x."""
    try:
        trainer = _TRAINERS[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; known: {sorted(_TRAINERS)}") from None
    return trainer(x, seed=seed, device=device, **opts)
