"""Backend adapters behind the one Index protocol (``repro.index.backends``).

First-party backends:

  pmtree    — the paper-faithful host index (Algorithms 1-5, counted
              work); its projections run on the index's device
  flat      — the dense estimate → select → verify pipeline on the card
  flat-pq   — the flat pipeline over PQ codes with an ADC rerank tier

(the mutable ``streaming`` backend registers from ``repro_torch.stream``)
and every competitor of the §7 study registers under the same protocol
through thin host adapters, so sweeps are a registry iteration.  Host
backends loop over the batch internally; the flat backends are batched
on the card.  The sharded backends of the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from ..core.ann import PMLSH, host_rows
from ..core.baselines import (
    ACPP,
    LScan,
    LSBTree,
    MkCP,
    MultiProbe,
    NLJ,
    QALSH,
    RLSH,
    SRS,
)
from ..core.cp import PMLSH_CP
from ..core.cp_fused import cp_fused_search
from ..core.flat_index import (
    FlatIndex,
    ann_query,
    answer_distances,
    build_flat_index,
    candidate_budget,
)
from ..core.hashing import host_projection
from ..device import resolve_device
from ..obs import trace as otrace
from ..quant import quant_ann_query, quant_cp_search, train_codec
from .config import IndexConfig
from .registry import register_backend
from .types import CpSearchResult, SearchResult, WorkStats, pack_batch

__all__ = ["BaseIndex", "PMTreeBackend", "FlatBackend", "FlatPQBackend"]


def _ctor_kwargs(cls, config: IndexConfig, **common) -> dict:
    """config.options + common kwargs, filtered to what cls.__init__
    accepts (constructors with **kwargs take everything)."""
    kw = {**common, **config.options}
    params = inspect.signature(cls.__init__).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return kw
    return {k: v for k, v in kw.items() if k in params}


class BaseIndex:
    """Common construction / validation shared by all adapters."""

    backend_name = "base"
    capabilities: frozenset = frozenset()

    def __init__(self, data: np.ndarray | torch.Tensor,
                 config: IndexConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or IndexConfig()
        self.device = resolve_device(device)
        # rows handed over as a tensor (a streaming segment's, already
        # on the device) stay one; anything else is host float32
        self.data = (data if isinstance(data, torch.Tensor)
                     else np.asarray(data, dtype=np.float32))
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
        with otrace.span("index.search", backend=self.backend_name,
                         B=int(q.shape[0]), k=k) as sp:
            res = self._search(q, min(k, self.n))
            if n_bad:
                res = SearchResult(
                    np.where(bad_rows[:, None], np.int32(-1), res.indices),
                    np.where(bad_rows[:, None], np.float32(np.inf), res.distances),
                    stats=res.stats)
                res.stats.queries_rejected += n_bad
            if sp is not None:
                sp.attrs["work"] = res.stats.as_dict()
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
        if "cp" not in self.capabilities:
            raise NotImplementedError(
                f"backend {self.backend_name!r} does not support closest-pair")
        with otrace.span("index.cp_search", backend=self.backend_name,
                         k=int(k)) as sp:
            res = self._cp_search(int(k))
            if sp is not None:
                sp.attrs["work"] = res.stats.as_dict()
        return res

    def _cp_search(self, k: int) -> CpSearchResult:
        raise NotImplementedError

    # -- storage accounting ----------------------------------------------

    def bytes_per_point(self) -> float:
        """Bytes/point of the index's DISTANCE storage — what the
        search tiers read to score a point (raw float32 here; codes +
        amortized codebooks for quantized backends).  The m-dim
        projection (4m bytes, identical across variants) and any
        retained raw rerank vectors are excluded — see
        ``raw_bytes_per_point``."""
        return 4.0 * self.d

    def raw_bytes_per_point(self) -> float:
        """Bytes/point of full-precision vectors kept for exact
        verification (0 when a quantized backend dropped them)."""
        return 4.0 * self.d

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(backend={self.backend_name!r}, "
                f"n={self.n}, d={self.d}, device={self.device})")


@register_backend("pmtree", capabilities=("ann", "cp"))
class PMTreeBackend(BaseIndex):
    """Paper-faithful PM-tree index (host DFS, full work counters).

    The data's projection runs once on the index's device, each query's
    at search time; the two trees (the ANN one, fanout 4, and the CP
    one, fanout 2) are built from it on the host on first use, so
    CP-only callers never pay for the ANN tree and vice versa.
    ``options`` reach the ``PMLSH`` / ``PMLSH_CP`` constructors (``s``,
    ``capacity``, ``builder``, ...); ``cp_search`` reads
    ``options["cp_T"]``, the candidate-pair budget.
    """

    def __init__(self, data, config: IndexConfig | None = None, *,
                 device: str | torch.device = "cuda", a: np.ndarray | None = None,
                 projected: np.ndarray | None = None):
        self._given_a = a
        self._given_projected = projected
        super().__init__(data, config, device=device)

    @classmethod
    def from_arrays(cls, data, a: np.ndarray, projected: np.ndarray | None = None,
                    config: IndexConfig | None = None, *,
                    device: str | torch.device = "cuda") -> "PMTreeBackend":
        """An index over ``data`` with the projection A given, e.g. the
        JAX index's ``impl.family.a`` (and, optionally, its
        ``impl.projected``, from which it then builds the JAX index's
        trees).  ``data`` may be a tensor on ``device``; the index
        projects it there and keeps a host copy."""
        return cls(data, config, device=device, a=a, projected=projected)

    def _build(self) -> None:
        cfg = self.config
        family, self.projected = host_projection(
            self.data, cfg.m, seed=cfg.seed, a=self._given_a,
            projected=self._given_projected, device=self.device)
        self.a = family.a.cpu().numpy()
        self.data = host_rows(self.data)
        self._ann_impl: PMLSH | None = None
        self._cp_impl: PMLSH_CP | None = None

    def _impl_kwargs(self, cls, c: float) -> dict:
        cfg = self.config
        return _ctor_kwargs(cls, cfg, m=cfg.m, c=c, seed=cfg.seed, a=self.a,
                            projected=self.projected, device=self.device)

    @property
    def impl(self) -> PMLSH:
        if self._ann_impl is None:
            self._ann_impl = PMLSH(self.data, **self._impl_kwargs(PMLSH, self.config.c))
        return self._ann_impl

    @property
    def cp_impl(self) -> PMLSH_CP:
        if self._cp_impl is None:
            self._cp_impl = PMLSH_CP(self.data,
                                     **self._impl_kwargs(PMLSH_CP, self.config.cp_c))
        return self._cp_impl

    def _search(self, q: np.ndarray, k: int) -> SearchResult:
        rows, stats = [], WorkStats()
        for qi in q:
            r = self.impl.ann_query(qi, k=k)
            rows.append((r.indices, r.distances))
            stats += WorkStats(
                rounds=r.rounds,
                candidates_verified=r.candidates_verified,
                node_distance_computations=r.stats.node_distance_computations,
                point_distance_computations=r.stats.point_distance_computations,
            )
        return SearchResult(*pack_batch(rows, k), stats=stats)

    def _cp_search(self, k: int) -> CpSearchResult:
        r = self.cp_impl.cp_query(k=k, T=self.config.options.get("cp_T"))
        return CpSearchResult(
            r.pairs, r.distances,
            stats=WorkStats(rounds=r.nodes_examined,
                            candidates_verified=r.pairs_verified,
                            pairs_verified=r.pairs_verified),
        )


@register_backend("flat", capabilities=("ann", "cp"))
class FlatBackend(BaseIndex):
    """The dense pipeline on the card, batched.

    Queries run the fused estimate → select → verify pipeline when the
    index is large enough for the threshold passes to beat the sort
    (n ≥ 8192, the reference's policy) and k ≤ 128;
    ``options={"fused": True/False}`` pins either pipeline (identical
    answers on ties-free data).  ``options={"force": "plain"}``, or
    ``options={"use_kernels": False}`` as the reference names it, runs
    the kernels' plain PyTorch versions on the card; an explicit
    ``force`` wins.

    ``cp_search`` sorts the points by the build-time projection's first
    coordinate and runs the pair join with Algorithm 4's γ·t·ub filter;
    ``options={"cp_gamma": γ}`` scales the filter.

    With ``options={"quant": "sq8"|"pq"}`` a codec is trained at build
    time and every point encoded; queries rerank the T candidates by ADC
    distance on the codes before exact-verifying the best ``rerank``
    rows (default max(4k, T/3, 64)).  Codec options nest under the
    codec's name (``{"pq": {"m_codebooks": 32}}``); ``store_raw=False``
    drops the float rows and answers from the ADC estimates.  CP joins
    the decoded codes and re-verifies ``cp_rerank`` estimated pairs.
    """

    def __init__(self, data: np.ndarray, config: IndexConfig | None = None, *,
                 device: str | torch.device = "cuda",
                 impl: FlatIndex | None = None, codec=None,
                 codes: np.ndarray | None = None):
        self._given_impl = impl
        self._given_codec = codec
        self._given_codes = codes
        super().__init__(data, config, device=device)

    @classmethod
    def from_arrays(cls, data: np.ndarray | torch.Tensor, a: np.ndarray,
                    projected: np.ndarray | None = None,
                    config: IndexConfig | None = None, *,
                    device: str | torch.device = "cuda", codec=None,
                    codes: np.ndarray | None = None) -> "FlatBackend":
        """A facade over ``data`` with the projection A given, e.g. the
        JAX index's ``family.a`` (and, optionally, its ``projected``), so
        it answers what the JAX facade answers on the same data.
        ``data`` may be a tensor on ``device``, which the index then
        holds without a copy.  A
        quantized index also takes the codec (``convert.
        codec_from_arrays``) and, optionally, the JAX index's codes."""
        from ..convert import flat_index_from_arrays

        config = config or IndexConfig()
        impl = flat_index_from_arrays(data, a, projected, c=config.c,
                                      m=config.m, device=device)
        return cls(data, config, device=device, impl=impl, codec=codec,
                   codes=codes)

    def _build(self) -> None:
        cfg = self.config
        # explicit dispatch, else derived from use_kernels as the
        # reference does (repro/index/backends.py:305-307)
        self.force = cfg.options.get("force")
        if self.force is None and not cfg.options.get("use_kernels", True):
            self.force = "plain"
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
        rerank = cfg.options.get("rerank")
        self.rerank = None if rerank is None else int(rerank)
        self.store_raw = bool(cfg.options.get("store_raw", True))
        self._cp_recon = None
        self.codec = self._given_codec
        qname = cfg.options.get("quant")
        if self.codec is None and qname is not None:
            copts = dict(cfg.options.get(qname) or {})
            seed = copts.pop("seed", cfg.seed)  # codec-level seed wins
            host = (self.data.cpu().numpy() if isinstance(self.data, torch.Tensor)
                    else self.data)  # the trainers are numpy's
            self.codec = train_codec(str(qname), host, seed=seed,
                                     device=self.device, **copts)
        if self.codec is None:
            self.codes = None
            return
        if self._given_codes is not None:
            self.codes = torch.from_numpy(
                np.array(self._given_codes, dtype=np.uint8)).to(self.device)
        else:
            self.codes = self.codec.encode(self.impl.data)
        if not self.store_raw:  # the codes are the point storage now
            self.impl = dataclasses.replace(
                self.impl, data=torch.zeros((0, self.d), device=self.device))
            self.data = np.empty((0, self.d), dtype=np.float32)

    def _record_select(self, counts: np.ndarray, T: int) -> int:
        """Keep the last batch's per-query select survivor counts and the
        budget T they were selected under (the streaming index's drift
        monitor reads both off its segments), and return the counts' sum
        for ``WorkStats.candidates_selected``."""
        self.last_select_counts = np.asarray(counts, dtype=np.int64)
        self.last_select_budget = int(T)
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
        if self.codec is None:
            if otrace.enabled() and not fused:
                # the reference runs this pipeline as one jit call: one
                # span bounds it, with nothing recorded inside
                with otrace.span("ann.query", B=B, n=self.n, k=k, T=T, fused=False):
                    with otrace.paused():
                        ids, _, cnt = ann_query(self.impl, qt, k=k, T=T, fused=False,
                                                force=self.force, with_count=True)
                    otrace.block(ids, cnt)
            else:  # the fused pipeline opens its own ann.* spans
                ids, _, cnt = ann_query(self.impl, qt, k=k, T=T, fused=fused,
                                        force=self.force, with_count=True)
            # canonical answer floats; the pipeline's d² only ranked candidates
            dd = answer_distances(self.impl.data, ids, qt)
            return SearchResult(
                ids.cpu().numpy(), dd.cpu().numpy(),
                stats=WorkStats(rounds=B, candidates_verified=B * T,
                                candidates_selected=self._record_select(
                                    cnt.cpu().numpy(), T)),
            )
        rerank = (self.rerank if self.rerank is not None
                  else max(4 * k, T // 3, 64))
        R = min(max(rerank, k), T)
        ids, dd, cnt = quant_ann_query(
            self.impl, self.codec, self.codes, qt, k=k, T=T, R=R,
            store_raw=self.store_raw, force=self.force, fused=fused,
            with_count=True)
        return SearchResult(
            ids.cpu().numpy(), dd.cpu().numpy(),
            stats=WorkStats(
                rounds=B,
                candidates_verified=B * R if self.store_raw else 0,
                candidates_selected=self._record_select(cnt.cpu().numpy(), T),
                point_distance_computations=B * T,  # the ADC rerank tier
            ),
        )

    def _cp_search(self, k: int) -> CpSearchResult:
        cfg = self.config
        gamma = float(cfg.options.get("cp_gamma", 1.0))
        key = self.impl.projected[:, 0]
        if self.codec is None:
            r = cp_fused_search(self.impl.data, k, m=cfg.m, c=cfg.cp_c,
                                gamma=gamma, force=self.force, key=key)
            return CpSearchResult(
                r.pairs, r.distances,
                stats=WorkStats(candidates_verified=r.pairs_verified,
                                pairs_verified=r.pairs_verified,
                                tiles_pruned=r.tiles_pruned),
            )
        if self.store_raw and self._cp_recon is None:
            # the codes never change: decode once; a codes-only index
            # keeps the decode transient, per call
            self._cp_recon = self.codec.decode(self.codes)
        R = cfg.options.get("cp_rerank")
        pairs, dd, est, verified, pruned = quant_cp_search(
            self.codec, self.codes, key, k,
            raw=self.impl.data if self.store_raw else None,
            R=None if R is None else int(R), c=cfg.cp_c, m=cfg.m,
            gamma=gamma, force=self.force, recon=self._cp_recon)
        return CpSearchResult(
            pairs, dd,
            stats=WorkStats(candidates_verified=verified,
                            point_distance_computations=est,
                            pairs_verified=verified if self.store_raw else est,
                            tiles_pruned=pruned),
        )

    def bytes_per_point(self) -> float:
        if self.codec is None:
            return 4.0 * self.d
        per_point = self.codec.bytes_per_point
        codebook = getattr(self.codec, "codebook_bytes", 0)
        return per_point + codebook / max(self.n, 1)

    def raw_bytes_per_point(self) -> float:
        if self.codec is not None and not self.store_raw:
            return 0.0
        return 4.0 * self.d


@register_backend("flat-pq", capabilities=("ann", "quant", "cp"))
class FlatPQBackend(FlatBackend):
    """The flat pipeline with PQ codes and the ADC rerank pre-wired: PQ
    is trained at build time unless the config names a codec."""

    def _build(self) -> None:
        if "quant" not in self.config.options:
            self.config = self.config.with_options(quant="pq")
        super()._build()


# ---------------------------------------------------------------------------
# §7 competitor baselines — generic host adapters
# ---------------------------------------------------------------------------


class _HostBaseline(BaseIndex):
    """Adapter over the baseline contract:
    query(q, k) -> (ids, dist, work) / cp_query(k) -> (pairs, dist, work).
    """

    impl_cls: type = None  # set per registered subclass

    def _build(self) -> None:
        cfg = self.config
        kw = _ctor_kwargs(self.impl_cls, cfg, c=cfg.c, seed=cfg.seed,
                          device=self.device)
        self.impl = self.impl_cls(host_rows(self.data), **kw)

    def _search(self, q: np.ndarray, k: int) -> SearchResult:
        rows, work = [], 0
        for qi in q:
            ids, dd, w = self.impl.query(qi, k)
            rows.append((ids, dd))
            work += int(w)
        return SearchResult(
            *pack_batch(rows, k),
            stats=WorkStats(rounds=q.shape[0], candidates_verified=work),
        )

    def _cp_search(self, k: int) -> CpSearchResult:
        pairs, dd, work = self.impl.cp_query(k)
        return CpSearchResult(
            pairs, dd, stats=WorkStats(candidates_verified=int(work),
                                       pairs_verified=int(work)))


_BASELINES = [
    # (registry name, implementation, capabilities)
    ("multiprobe", MultiProbe, ("ann",)),
    ("qalsh", QALSH, ("ann",)),
    ("srs", SRS, ("ann",)),
    ("rlsh", RLSH, ("ann",)),
    ("lscan", LScan, ("ann",)),
    ("lsb_tree", LSBTree, ("ann", "cp")),
    ("acp_p", ACPP, ("cp",)),
    ("mkcp", MkCP, ("cp",)),
    ("nlj", NLJ, ("cp",)),
]

for _name, _impl, _caps in _BASELINES:
    register_backend(_name, capabilities=_caps)(
        type(
            f"{_impl.__name__}Backend",
            (_HostBaseline,),
            {"impl_cls": _impl,
             "__doc__": f"Registry adapter over baselines.{_impl.__name__}."},
        )
    )
