"""Carry a JAX flat index across to the port.

The JAX package draws the projection A with ``jax.random.normal``,
which torch cannot reproduce, so a port index that must answer what a
JAX index answers takes that index's arrays as numpy:

    ji = repro.index.build_index(data, IndexConfig(backend="flat"))
    ti = repro_torch.index.FlatBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected))

This module imports nothing of JAX; the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.estimator import solve_parameters
from .core.flat_index import FlatIndex
from .core.hashing import ProjectionFamily
from .device import as_tensor, resolve_device

__all__ = ["flat_index_from_arrays"]


def flat_index_from_arrays(data: np.ndarray, a: np.ndarray,
                           projected: np.ndarray | None = None, *,
                           c: float = 1.5, m: int | None = None,
                           device: str | torch.device = "cuda") -> FlatIndex:
    """A :class:`FlatIndex` over ``data`` (n, d) with projection ``a``
    (d, m); ``projected`` (n, m) is taken as given when passed (the JAX
    index's own ``data @ a``), else computed here."""
    dev = resolve_device(device)
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
