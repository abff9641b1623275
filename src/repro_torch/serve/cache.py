"""SQ8-keyed hot-query cache: LRU over quantized query codes (the port of
``repro.serve.cache``).

Production retrieval traffic is heavily repeated (hot prompts, retry
storms, near-duplicate embeddings).  The cache key is the query's SQ8
code vector (``repro_torch.quant.SQ8Codec`` — 1 byte/dim, the same
codec the quantized storage tier uses), so two float queries that land
on the same int8 grid cell share one entry: exact repeats always
collide, and near-duplicates within half a grid step collide too —
which is precisely the resolution below which the index would return
the same neighbors anyway.  The stored value is the full
``SearchResult``; a hit returns a bit-identical copy without touching
the index.

Consistency: every entry is stamped with the datastore ``version`` it
was computed against (``RetrievalStep.version``, bumped by
extend/evict).  ``invalidate()`` clears the table and bumps the
cache's own generation; the scheduler calls it from its extend/evict
wrappers, and version-stamped gets refuse stale entries even if a
caller mutates the step behind the scheduler's back.

The codec is trained once — on the datastore rows when available — and
never retrained: key stability matters more than key optimality, and a
retrain would silently orphan every live entry.  The codec trains on
the host rows the facade keeps (``index.data``) and stays on the host:
keys are computed there, so it never needs the card.  ``ensure_codec``
refuses degenerate training sets: fewer than two rows, or zero spread
on every dimension, would collapse the grid so far that arbitrarily
distant queries share a key.
Without a codec (codes-only datastores whose own codec is not SQ8)
``key`` falls back to the query's exact float32 bytes, so only
bit-identical repeats hit — strictly conservative, never wrong.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..index.types import SearchResult
from ..quant.codec import train_sq8

__all__ = ["SQ8QueryCache"]


def _copy_result(res: SearchResult) -> SearchResult:
    return SearchResult(res.indices.copy(), res.distances.copy(),
                        stats=dataclasses.replace(res.stats))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(x, np.float32)


class SQ8QueryCache:
    """Bounded LRU: (SQ8 codes of query, k) → SearchResult."""

    def __init__(self, capacity: int = 1024, codec=None):
        self.capacity = int(capacity)
        self.codec = None  # trained lazily via ensure_codec
        self._scale = self._offset = None  # host-side codec mirror
        self.generation = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self._table: OrderedDict[tuple[bytes, int], tuple[int, SearchResult]]
        self._table = OrderedDict()
        if codec is not None:
            self.adopt(codec)

    def adopt(self, codec) -> None:
        """Key on an already-trained SQ8 codec (e.g. the one a
        codes-only datastore trained on its full rows before dropping
        them).  Must happen before any entries are inserted."""
        self.codec = codec
        # keying runs per submit on the host hot path: mirror the
        # codec's affine grid as numpy so no device dispatch is paid
        self._scale = _host(codec.scale)
        self._offset = _host(codec.offset)

    def __len__(self) -> int:
        return len(self._table)

    # -- codec -----------------------------------------------------------

    def ensure_codec(self, rows) -> bool:
        """Train the SQ8 key codec on ``rows`` if not trained yet.
        Returns True when a usable codec is in place.

        Refuses degenerate training sets — fewer than two rows, or no
        spread on any dimension.  ``train_sq8`` clamps zero-range dims
        to a 1e-12 grid step, so a degenerate codec keys every query by
        its clipped sign pattern and arbitrarily distant queries
        collide; better to stay codec-less (exact-bytes keying) than to
        serve another query's answer as a "hit"."""
        if self.codec is not None:
            return True
        if rows is None:
            return False
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[0] < 2:
            return False
        if not (np.ptp(rows, axis=0) > 0).any():
            return False  # all rows identical: every grid step collapses
        self.adopt(train_sq8(rows, device="cpu"))
        return True

    def key(self, q: np.ndarray, k: int) -> tuple[bytes, int]:
        """(SQ8 codes bytes, k) for one query row.  Pure numpy
        (round-half-even like the codec's torch.round), so keying costs
        microseconds, not a device dispatch.

        Without a codec the key is the query's exact float32 bytes —
        only bit-identical repeats collide.  The two key spaces are
        prefix-tagged so adopting a codec later can never alias an
        exact-bytes entry."""
        q = np.asarray(q, np.float32).reshape(-1)
        if self.codec is None:
            return b"raw:" + q.tobytes(), int(k)
        v = np.round((q - self._offset) / self._scale)
        codes = np.clip(v, 0, self.codec.V - 1).astype(np.uint8)
        return b"sq8:" + codes.tobytes(), int(k)

    # -- lookup / fill ---------------------------------------------------

    def get(self, key, *, version: int = 0) -> SearchResult | None:
        """Version-checked lookup; a hit refreshes LRU recency."""
        if key is None or key not in self._table:
            self.misses += 1
            return None
        entry_version, res = self._table[key]
        if entry_version != version:  # stale: datastore mutated past it
            del self._table[key]
            self.misses += 1
            return None
        self._table.move_to_end(key)
        self.hits += 1
        return _copy_result(res)

    def put(self, key, res: SearchResult, *, version: int = 0) -> None:
        if key is None or self.capacity <= 0:
            return
        self._table[key] = (version, _copy_result(res))
        self._table.move_to_end(key)
        self.insertions += 1
        while len(self._table) > self.capacity:
            self._table.popitem(last=False)
            self.evictions += 1

    def invalidate(self) -> None:
        """Drop every entry (datastore mutated: extend/evict)."""
        self.generation += 1
        self._table.clear()
