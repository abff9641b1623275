"""Carry a JAX index across to the port.

The JAX package draws the projection A with ``jax.random.normal``,
which torch cannot reproduce, so a port index that must answer what a
JAX index answers takes that index's arrays as numpy:

    ji = repro.index.build_index(data, IndexConfig(backend="flat"))
    ti = repro_torch.index.FlatBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected))

A quantized index also carries its codec and codes across: PQ encoding
is an argmin whose near-ties can fall either way between XLA's and
torch's summation orders, so a port index that must answer what a JAX
``flat-pq`` index answers takes the JAX codes too:

    codec = codec_from_arrays(centroids=np.asarray(ji.codec.centroids),
                              d=ji.codec.d)
    ti = repro_torch.index.FlatPQBackend.from_arrays(
        data, a, projected, config, codec=codec, codes=np.asarray(ji.codes))

A PM-tree index is carried the same way, and with the JAX index's
``projected`` it builds the JAX index's trees:

    ji = repro.index.build_index(data, IndexConfig(backend="pmtree"))
    ti = repro_torch.index.PMTreeBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected))

The bucket baselines (Multi-Probe, LSB-tree) take their JAX families'
arrays through :func:`bucket_families_from_arrays`, and SRS / R-LSH take
``a`` and ``projected`` as options:

    fams = bucket_families_from_arrays(
        [(np.asarray(f.a), np.asarray(f.b), f.w) for f, _ in jax_mp.tables])
    ti = build_index(data, IndexConfig(backend="multiprobe",
                                       options={"families": fams}))

This module imports nothing of JAX; the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.estimator import solve_parameters
from .core.flat_index import FlatIndex
from .core.hashing import BucketFamily, ProjectionFamily
from .device import as_tensor, resolve_device
from .quant.codec import PQCodec, SQ8Codec

__all__ = ["flat_index_from_arrays", "codec_from_arrays", "bucket_families_from_arrays"]


def flat_index_from_arrays(data: np.ndarray | torch.Tensor, a: np.ndarray,
                           projected: np.ndarray | None = None, *,
                           c: float = 1.5, m: int | None = None,
                           device: str | torch.device = "cuda") -> FlatIndex:
    """A :class:`FlatIndex` over ``data`` (n, d) with projection ``a``
    (d, m); ``projected`` (n, m) is taken as given when passed (the JAX
    index's own ``data @ a``), else computed here.  A ``data`` tensor
    already on ``device`` is used without a copy."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        data_t = data.to(device=dev, dtype=torch.float32).contiguous()
    else:
        data_t = as_tensor(data, dev)
    family = ProjectionFamily.from_numpy(a, dev)
    if family.d != data_t.shape[1]:
        raise ValueError(f"a is ({family.d}, {family.m}) for data of d={data_t.shape[1]}")
    if m is not None and m != family.m:
        raise ValueError(f"m={m} but a has {family.m} columns")
    if projected is None:
        proj = family.project(data_t)
    else:
        proj = as_tensor(projected, dev)
        if tuple(proj.shape) != (data_t.shape[0], family.m):
            raise ValueError(f"projected {tuple(proj.shape)} for data "
                             f"{tuple(data_t.shape)} and m={family.m}")
    return FlatIndex(data=data_t, projected=proj, family=family,
                     params=solve_parameters(c, m=family.m))


def codec_from_arrays(*, scale: np.ndarray | None = None,
                      offset: np.ndarray | None = None,
                      centroids: np.ndarray | None = None, d: int | None = None,
                      device: str | torch.device = "cuda") -> SQ8Codec | PQCodec:
    """The port's codec from a JAX codec's arrays: ``centroids`` (S, V,
    ds) and ``d`` for PQ, or ``scale`` and ``offset`` (d,) for SQ8."""
    dev = resolve_device(device)
    if centroids is not None:
        cents = as_tensor(centroids, dev)
        if cents.ndim != 3 or d is None or not 1 <= d <= cents.shape[0] * cents.shape[2]:
            raise ValueError(f"PQ needs centroids (S, V, ds) and d ≤ S·ds, got "
                             f"{tuple(cents.shape)} and d={d}")
        return PQCodec(centroids=cents, d=int(d))
    if scale is None or offset is None:
        raise ValueError("codec_from_arrays needs centroids and d (PQ) or "
                         "scale and offset (SQ8)")
    scale_t, offset_t = as_tensor(scale, dev), as_tensor(offset, dev)
    if scale_t.ndim != 1 or scale_t.shape != offset_t.shape:
        raise ValueError(f"SQ8 needs scale and offset of one shape (d,), got "
                         f"{tuple(scale_t.shape)} and {tuple(offset_t.shape)}")
    return SQ8Codec(scale=scale_t, offset=offset_t)


def bucket_families_from_arrays(families, *, device: str | torch.device = "cuda"
                                ) -> list[BucketFamily]:
    """The port's bucket families from (a (d, m), b (m,), w) triples,
    e.g. a JAX Multi-Probe index's tables' or an LSB-tree's trees'."""
    dev = resolve_device(device)
    return [BucketFamily.from_numpy(a, b, w, dev) for a, b, w in families]
