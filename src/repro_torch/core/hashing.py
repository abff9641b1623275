"""2-stable LSH hash families (paper §2.2, Eq. 1 and Eq. 3).

* :class:`ProjectionFamily` — m un-quantized hash functions
  h*_i(o) = a_i · o stacked into one (d, m) Gaussian matrix (PM-LSH
  itself, SRS); projecting a batch is one matrix product.
* :class:`BucketFamily` — the E2LSH quantized hash
  h(o) = ⌊(a·o + b)/w⌋ of the bucket baselines (Multi-Probe, LSB-tree).

The JAX package draws A (and b) with ``jax.random``, which torch cannot
reproduce, so a family is either drawn here from a ``torch.Generator``
or built from given arrays (``from_numpy``), which is how an index is
carried across from JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["ProjectionFamily", "BucketFamily", "host_projection", "project_to_host",
           "hash_to_host"]


@dataclasses.dataclass(frozen=True)
class ProjectionFamily:
    """m un-quantized 2-stable hash functions h*_i(o) = a_i · o  (Eq. 3).

    Attributes:
      a: (d, m) float32 tensor; column i is the Gaussian vector of h*_i.
    """

    a: torch.Tensor  # (d, m)

    @property
    def d(self) -> int:
        return self.a.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @staticmethod
    def create(d: int, m: int, *, generator: torch.Generator,
               device: str | torch.device) -> "ProjectionFamily":
        """Draw A ~ N(0, 1)^(d, m) from ``generator`` (on the generator's
        own device, so a CPU generator gives the same A for any
        ``device``)."""
        a = torch.randn((d, m), generator=generator, dtype=torch.float32,
                        device=generator.device)
        return ProjectionFamily(a=a.to(device))

    @staticmethod
    def from_seed(d: int, m: int, seed: int,
                  device: str | torch.device) -> "ProjectionFamily":
        """The draw every index of the port makes from ``seed``: a CPU
        generator seeded with it."""
        return ProjectionFamily.create(d, m, generator=torch.Generator().manual_seed(seed),
                                       device=device)

    @staticmethod
    def from_numpy(a: np.ndarray, device: str | torch.device) -> "ProjectionFamily":
        """Take A as given, e.g. the JAX family's ``a``."""
        a = as_tensor(a, torch.device(device))
        if a.ndim != 2:
            raise ValueError(f"a must be (d, m), got shape {tuple(a.shape)}")
        return ProjectionFamily(a=a)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Project points (..., d) into the m-dim hash space: x @ a."""
        return x.to(torch.float32) @ self.a

    def project_rounded(self, x: torch.Tensor) -> torch.Tensor:
        """x @ a summed in float64 and rounded once to float32.

        A float32 sum's order, and so its last bit, differs between the
        card's BLAS and the CPU's; the PM-tree's splits and range tests
        compare such coordinates, so the host index takes them from a
        sum whose rounding to float32 every device agrees on."""
        return (x.to(torch.float64) @ self.a.to(torch.float64)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class BucketFamily:
    """m quantized 2-stable hash functions h_i(o) = ⌊(a_i·o + b_i)/w⌋ (Eq. 1)."""

    a: torch.Tensor  # (d, m)
    b: torch.Tensor  # (m,)
    w: float

    @property
    def d(self) -> int:
        return self.a.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[1]

    @staticmethod
    def create(d: int, m: int, w: float, *, seed: int,
               device: str | torch.device) -> "BucketFamily":
        """Draw A ~ N(0, 1)^(d, m), then b ~ U[0, w)^m, from a CPU
        generator seeded with ``seed``, as
        :meth:`ProjectionFamily.from_seed` draws."""
        gen = torch.Generator().manual_seed(seed)
        a = torch.randn((d, m), generator=gen, dtype=torch.float32)
        b = torch.rand((m,), generator=gen, dtype=torch.float32) * w
        return BucketFamily(a=a.to(device), b=b.to(device), w=float(w))

    @staticmethod
    def from_numpy(a: np.ndarray, b: np.ndarray, w: float,
                   device: str | torch.device) -> "BucketFamily":
        """Take A, b and w as given, e.g. a JAX family's."""
        dev = torch.device(device)
        a_t, b_t = as_tensor(a, dev), as_tensor(b, dev)
        if a_t.ndim != 2 or tuple(b_t.shape) != (a_t.shape[1],):
            raise ValueError(f"a must be (d, m) and b (m,), got {tuple(a_t.shape)} "
                             f"and {tuple(b_t.shape)}")
        return BucketFamily(a=a_t, b=b_t, w=float(w))

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        """Un-floored hash value (a·x + b)/w, useful for probing sequences."""
        return (x.to(torch.float32) @ self.a + self.b) / self.w

    def hash(self, x: torch.Tensor) -> torch.Tensor:
        """Integer bucket coordinates, (..., m) int32."""
        return torch.floor(self.raw(x)).to(torch.int32)


def project_to_host(family: ProjectionFamily, x) -> np.ndarray:
    """Rows ``x`` (n, d), numpy or a tensor, projected on the family's
    device by :meth:`ProjectionFamily.project_rounded`, as host float32
    (n, m): the coordinates the host indexes (PM-tree, R-tree) use."""
    dev = family.a.device
    xt = x.to(dev) if isinstance(x, torch.Tensor) else as_tensor(x, dev)
    return family.project_rounded(xt).cpu().numpy()


def host_projection(x, m: int, *, seed: int, a: np.ndarray | None = None,
                    projected: np.ndarray | None = None,
                    device: str | torch.device) -> tuple[ProjectionFamily, np.ndarray]:
    """The family and host projection of a host index over ``x`` (n, d).

    A is ``a`` when given (e.g. the JAX family's), else drawn from
    ``seed``; ``projected`` (n, m) is taken as given when passed (e.g.
    the JAX index's own), else computed by :func:`project_to_host`."""
    n, d = x.shape
    family = (ProjectionFamily.from_seed(d, m, seed, device) if a is None
              else ProjectionFamily.from_numpy(a, device))
    if (family.d, family.m) != (d, m):
        raise ValueError(f"a is ({family.d}, {family.m}) for d={d}, m={m}")
    if projected is None:
        return family, project_to_host(family, x)
    proj = np.asarray(projected, dtype=np.float32)
    if proj.shape != (n, m):
        raise ValueError(f"projected {proj.shape} for {n} rows and m={m}")
    return family, proj


def hash_to_host(family: BucketFamily, x: np.ndarray, raw: bool = False) -> np.ndarray:
    """``family.hash`` (or ``family.raw``) of host rows ``x`` on the
    family's device, back as numpy."""
    xt = as_tensor(x, family.a.device)
    return (family.raw(xt) if raw else family.hash(xt)).cpu().numpy()
