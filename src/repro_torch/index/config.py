"""IndexConfig — the one knob panel shared by every backend.

The fields every PM-LSH-contract index understands (approximation ratio
c, projected dimensionality m, seed, default k) live at top level;
anything backend-specific rides in ``options`` and is read by the
backend (e.g. ``{"fused": True}`` to pin the flat backend's fused
pipeline, ``{"use_kernels": False}`` to run the kernels' plain
PyTorch versions on the card).  A copy of ``repro.index.config``, so configs
read the same in both packages.

``options`` is normalized to an immutable ``FrozenOptions`` mapping at
construction: the caller's dict is copied (no aliasing — mutating it
later cannot change the config) and the config stays hashable, so it
works as a cache / sweep key.  Freezing is DEEP: nested mappings become
``FrozenOptions`` and nested lists/sets become tuples, so structured
options like ``{"pq": {"m_codebooks": 16}}`` hash too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

__all__ = ["IndexConfig", "FrozenOptions"]


def _freeze(value: Any) -> Any:
    """Recursively convert mappings/sequences to hashable equivalents."""
    if isinstance(value, Mapping):
        return FrozenOptions(value)
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(_freeze(v) for v in value))
    return value


class FrozenOptions(Mapping):
    """Immutable, hashable Mapping — the normal form of ``options``."""

    __slots__ = ("_items", "_hash")

    def __init__(self, items: Mapping[str, Any] | None = None):
        frozen = {k: _freeze(v) for k, v in dict(items or {}).items()}
        object.__setattr__(self, "_items", frozen)
        object.__setattr__(self, "_hash", None)

    def __getitem__(self, key: str) -> Any:
        return self._items[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __hash__(self) -> int:
        if self._hash is None:
            object.__setattr__(
                self, "_hash",
                hash(frozenset(self._items.items())),
            )
        return self._hash

    def __eq__(self, other) -> bool:
        if isinstance(other, Mapping):
            return dict(self._items) == dict(other)
        return NotImplemented

    def __setattr__(self, *_):  # pragma: no cover - defensive
        raise TypeError("FrozenOptions is immutable")

    def __repr__(self) -> str:
        return f"FrozenOptions({self._items!r})"


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    backend: str = "flat"
    c: float = 1.5  # ANN approximation ratio (Eq. 10 input)
    cp_c: float = 4.0  # CP approximation ratio (§6 default)
    m: int = 15  # hash functions / projected dims (where applicable)
    seed: int = 0
    default_k: int = 10  # used when search() is called without k
    options: Mapping[str, Any] = dataclasses.field(
        default_factory=FrozenOptions)

    def __post_init__(self):
        if not isinstance(self.options, FrozenOptions):
            object.__setattr__(self, "options", FrozenOptions(self.options))

    def replace(self, **kw) -> "IndexConfig":
        return dataclasses.replace(self, **kw)

    def with_options(self, **kw) -> "IndexConfig":
        return dataclasses.replace(self, options={**self.options, **kw})
