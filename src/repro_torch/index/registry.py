"""String-keyed backend registry + the build_index factory, as in
``repro.index.registry``.

Backends self-register:

    @register_backend("flat", capabilities=("ann",))
    class FlatBackend(BaseIndex): ...

and callers never import them directly:

    from repro_torch.index import IndexConfig, build_index
    index = build_index(data, IndexConfig(backend="flat"))   # on the card
    res = index.search(queries, k=10)

Every backend of the reference registers, in its order: ``pmtree``,
``flat``, ``flat-pq``, ``sharded``, ``sharded-flat``,
``sharded-flat-pq``, the nine §7 baselines and ``streaming``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .config import IndexConfig
from .types import Index

__all__ = ["register_backend", "build_index", "available_backends",
           "get_backend", "backend_capabilities", "KNOWN_CAPABILITIES"]

_REGISTRY: dict[str, type] = {}
_ORDER: list[str] = []  # registration order — the canonical sweep order

#: the capability vocabulary of ``repro.index.registry``
KNOWN_CAPABILITIES = frozenset({"ann", "cp", "stream", "quant"})


def register_backend(name: str, *, capabilities: Iterable[str] = ("ann",)):
    """Class decorator: publish a backend under ``name``."""
    caps = frozenset(capabilities)
    if not caps <= KNOWN_CAPABILITIES:
        raise ValueError(f"unknown capabilities {sorted(caps)}")

    def deco(cls):
        cls.backend_name = name
        cls.capabilities = caps
        if name not in _REGISTRY:
            _ORDER.append(name)
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str) -> type:
    _ensure_builtin_backends()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown index backend {name!r}; registered in repro_torch: "
            f"{', '.join(_ORDER)}"
        ) from None


def available_backends(capability: str | None = None) -> list[str]:
    """Registered backend names (registration order), optionally only
    those declaring ``capability``."""
    _ensure_builtin_backends()
    if capability is None:
        return list(_ORDER)
    return [n for n in _ORDER if capability in _REGISTRY[n].capabilities]


def backend_capabilities(name: str) -> frozenset[str]:
    return get_backend(name).capabilities


def build_index(data, config: IndexConfig | None = None, *,
                device: str | torch.device = "cuda", **overrides) -> Index:
    """Build an index over ``data`` (n, d) per ``config`` on ``device``.

    ``device`` defaults to the card and raises where CUDA is absent;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.  Keyword
    overrides are applied on top of the config:
    ``build_index(data, backend="flat", m=20)``.
    """
    config = (config or IndexConfig())
    if overrides:
        config = config.replace(**overrides)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"data must be (n, d), got shape {data.shape}")
    return get_backend(config.backend)(data, config, device=device)


def _ensure_builtin_backends() -> None:
    # backends.py / repro_torch.stream register on import; deferred to
    # avoid a cycle
    from . import backends  # noqa: F401
    from .. import stream  # noqa: F401
