"""Argument checks and stream handle shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

__all__ = ["checked", "stream_of"]


def checked(what: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
            device: torch.device | None = None) -> torch.Tensor:
    """``t`` if it is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` (on ``device`` when given); raises ValueError otherwise.
    A wrapper launches its kernel or raises: it never runs the plain
    version for a tensor it was handed."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}; repro_torch.kernels.ops runs "
                         "the plain version for CPU tensors")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: tensors on {t.device} and {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    return t


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
