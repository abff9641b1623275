"""The 2-stable projection family of PM-LSH (paper §2.2, Eq. 3).

:class:`ProjectionFamily` holds m un-quantized hash functions
h*_i(o) = a_i · o stacked into one (d, m) Gaussian matrix; projecting a
batch is one matrix product.  The JAX package draws A with
``jax.random.normal``, which torch cannot reproduce, so the family is
either drawn here from a ``torch.Generator`` or built from a given A
(``from_numpy``), which is how an index is carried across from JAX.
The quantized ``BucketFamily`` of the baselines is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["ProjectionFamily"]


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
    def from_numpy(a: np.ndarray, device: str | torch.device) -> "ProjectionFamily":
        """Take A as given, e.g. the JAX family's ``a``."""
        a = as_tensor(a, torch.device(device))
        if a.ndim != 2:
            raise ValueError(f"a must be (d, m), got shape {tuple(a.shape)}")
        return ProjectionFamily(a=a)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Project points (..., d) into the m-dim hash space: x @ a."""
        return x.to(torch.float32) @ self.a
