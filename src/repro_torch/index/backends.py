"""Backend adapters behind the one Index protocol (``repro.index.backends``).

The port has the flat backend: the dense estimate → select → verify
pipeline on the card, with the fused pipeline (radius-threshold select,
gather-free verify) from n = 8192 on.  Quantized storage and closest
pair are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.flat_index import (
    FlatIndex,
    ann_query,
    answer_distances,
    build_flat_index,
    candidate_budget,
)
from ..device import resolve_device
from .config import IndexConfig
from .registry import register_backend
from .types import CpSearchResult, SearchResult, WorkStats

__all__ = ["BaseIndex", "FlatBackend"]


class BaseIndex:
    """Common construction / validation shared by all adapters."""

    backend_name = "base"
    capabilities: frozenset = frozenset()

    def __init__(self, data: np.ndarray, config: IndexConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or IndexConfig()
        self.device = resolve_device(device)
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 2:
            raise ValueError(f"data must be (n, d), got {self.data.shape}")
        self.n, self.d = self.data.shape
        self._build()

    def _build(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    # -- ANN -------------------------------------------------------------

    def search(self, queries, k: int | None = None) -> SearchResult:
        if "ann" not in self.capabilities:
            raise NotImplementedError(
                f"backend {self.backend_name!r} does not support ANN search"
            )
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if q.shape[-1] != self.d:
            raise ValueError(f"queries have d={q.shape[-1]}, index d={self.d}")
        k = int(k if k is not None else self.config.default_k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        # non-finite query rows would poison any distance pipeline:
        # substitute a benign zero row for the backend, then mask those
        # rows to the sentinel answer (-1 / +inf) and count them in
        # WorkStats.queries_rejected
        bad_rows = ~np.isfinite(q).all(axis=1)
        n_bad = int(bad_rows.sum())
        if n_bad:
            q = np.where(bad_rows[:, None], np.float32(0.0), q)
        res = self._search(q, min(k, self.n))
        if n_bad:
            res = SearchResult(
                np.where(bad_rows[:, None], np.int32(-1), res.indices),
                np.where(bad_rows[:, None], np.float32(np.inf), res.distances),
                stats=res.stats)
            res.stats.queries_rejected += n_bad
        if res.k < k:  # k > n: keep the (B, k) contract via padding
            pad_i = np.full((res.batch, k), -1, dtype=np.int32)
            pad_d = np.full((res.batch, k), np.inf, dtype=np.float32)
            pad_i[:, : res.k] = res.indices
            pad_d[:, : res.k] = res.distances
            res = SearchResult(pad_i, pad_d, stats=res.stats)
        return res

    def _search(self, q: np.ndarray, k: int) -> SearchResult:
        raise NotImplementedError

    # -- CP --------------------------------------------------------------

    def cp_search(self, k: int) -> CpSearchResult:
        raise NotImplementedError(
            f"repro_torch backend {self.backend_name!r}: closest-pair search "
            "is not ported yet; it comes with the closest-pair slice "
            "(ROADMAP queue A item 4)")

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(backend={self.backend_name!r}, "
                f"n={self.n}, d={self.d}, device={self.device})")


@register_backend("flat", capabilities=("ann",))
class FlatBackend(BaseIndex):
    """The dense pipeline on the card, batched.

    Queries run the fused estimate → select → verify pipeline when the
    index is large enough for the threshold passes to beat the sort
    (n ≥ 8192, the reference's policy) and k ≤ 128;
    ``options={"fused": True/False}`` pins either pipeline (identical
    answers on ties-free data).  ``options={"force": "plain"}`` runs the
    kernels' plain PyTorch versions on the card.
    """

    def __init__(self, data: np.ndarray, config: IndexConfig | None = None, *,
                 device: str | torch.device = "cuda",
                 impl: FlatIndex | None = None):
        self._given_impl = impl
        super().__init__(data, config, device=device)

    @classmethod
    def from_arrays(cls, data: np.ndarray, a: np.ndarray,
                    projected: np.ndarray | None = None,
                    config: IndexConfig | None = None, *,
                    device: str | torch.device = "cuda") -> "FlatBackend":
        """A facade over ``data`` with the projection A given, e.g. the
        JAX index's ``family.a`` (and, optionally, its ``projected``), so
        it answers what the JAX facade answers on the same data."""
        from ..convert import flat_index_from_arrays

        config = config or IndexConfig()
        impl = flat_index_from_arrays(data, a, projected, c=config.c,
                                      m=config.m, device=device)
        return cls(data, config, device=device, impl=impl)

    def _build(self) -> None:
        cfg = self.config
        if cfg.options.get("quant") is not None:
            raise NotImplementedError(
                "repro_torch: quantized storage (options['quant']) is not "
                "ported yet; it comes with the quant slice (ROADMAP queue A "
                "item 5)")
        self.force = cfg.options.get("force")
        if self.force not in (None, "plain"):
            raise ValueError(f"options['force'] must be None or 'plain', "
                             f"got {self.force!r}")
        fused = cfg.options.get("fused")  # None → auto by index size
        self.fused = None if fused is None else bool(fused)
        if self._given_impl is not None:
            self.impl = self._given_impl
        else:
            self.impl = build_flat_index(self.data, m=cfg.m, seed=cfg.seed,
                                         c=cfg.c, device=self.device)

    def _record_select(self, counts: np.ndarray) -> int:
        """Keep the last batch's per-query select survivor counts and
        return their sum for ``WorkStats.candidates_selected``."""
        self.last_select_counts = np.asarray(counts, dtype=np.int64)
        return int(self.last_select_counts.sum())

    def _search(self, q: np.ndarray, k: int) -> SearchResult:
        T = candidate_budget(self.impl.params, self.n, k)
        B = q.shape[0]
        # auto policy: the fused pipeline's O(n) threshold passes beat
        # the O(n·T) sort once n is past the break-even; the fused
        # verify kernel's answer width also caps k
        fused = (self.fused if self.fused is not None
                 else self.n >= 8192) and k <= 128
        qt = torch.from_numpy(q).to(self.device)
        ids, _, cnt = ann_query(self.impl, qt, k=k, T=T, fused=fused,
                                force=self.force, with_count=True)
        # canonical answer floats; the pipeline's d² only ranked candidates
        dd = answer_distances(self.impl.data, ids, qt)
        return SearchResult(
            ids.cpu().numpy(), dd.cpu().numpy(),
            stats=WorkStats(rounds=B, candidates_verified=B * T,
                            candidates_selected=self._record_select(
                                cnt.cpu().numpy())),
        )
