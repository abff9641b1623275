"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``"cuda"`` raises where CUDA is absent instead of carrying on
quietly with the plain PyTorch versions.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor"]


def as_tensor(array, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device`` from a numpy-like array
    (copied when the array is read-only, as JAX's exports are)."""
    a = np.ascontiguousarray(array, dtype=np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if it names CUDA and there
    is no CUDA device, or if it is neither a CUDA device nor the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch versions of the kernels on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
