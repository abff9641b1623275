"""StreamingIndex — the mutable LSM-style index behind the facade, on
the card (``repro.stream.index``).

    inserts → delta buffer ──flush──▶ sealed segment (static backend)
    deletes → dropped from delta, or tombstoned against a segment
    search  → fan-out over segments + delta, one top-k merge on the
              card (the topk kernel), tombstones filtered at merge time
    compaction → when segments pile up or rot, the smallest are
              rebuilt — live rows only — into one larger segment

Id discipline: every inserted row gets a monotonically increasing
GLOBAL id (its row in the append-only vector store).  Ids are never
recycled.  Exactly one source — the delta or one segment — owns a live
id at any time, so the merge never sees duplicates.  The store, the
alive mask and the owner array stay on the host, as in the reference;
the delta's rows and every segment's index live on the index's device.

Registered as backend ``"streaming"`` with capabilities
``("ann", "stream", "cp")``:

    index = build_index(data, IndexConfig(backend="streaming"))
    ids = index.insert(new_rows)        # visible to search immediately
    index.delete(ids[:2])               # never returned again
    index.flush()                       # seal the delta eagerly

options: ``delta_threshold`` (flush trigger, default 512),
``segment_backend`` (any registered backend: "pmtree" by default, "flat"
when ``quant`` is set; a closest-pair-only one seals and fails at the
search, as the reference's does), ``max_segments`` (compaction trigger,
default 4),
``max_dead_fraction`` (segment rot trigger, default 0.5),
``use_kernels`` (False runs the plain PyTorch versions, in the delta
scan, the merge and the segments, default True), ``durability`` (crash
consistency: ``{"dir": path, "sync": True, "snapshot_every": 0}``
attaches a ``repro_torch.resilience`` WAL — every mutation is logged
before memory changes — plus atomic snapshots every N records; rebuild
after a crash with ``repro_torch.resilience.recover(dir)``, which reads
the reference's directories too).  Unrecognized options (``fused``,
``quant``, ``rerank``, ...) pass through to the segment backend.

Every segment's backend, the drift monitor and the closest-pair key
share one projection A (d, m): drawn as every index of the port draws it
from ``config.seed``, or given through :meth:`from_arrays` (e.g. the JAX
index's family), so a port index fed the same operations answers what
the JAX index answers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hashing import ProjectionFamily
from ..device import as_tensor
from ..index.backends import BaseIndex
from ..index.registry import register_backend
from ..index.types import CpSearchResult, SearchResult, WorkStats
from ..kernels import ops
from ..obs import trace as otrace
from ..resilience import chaos
from .delta import DeltaBuffer
from .segment import Segment

__all__ = ["StreamingIndex"]


@register_backend("streaming", capabilities=("ann", "stream", "cp"))
class StreamingIndex(BaseIndex):
    """Mutable Index: static-backend segments + delta + tombstones."""

    def __init__(self, data: np.ndarray, config=None, *,
                 device: str | torch.device = "cuda", a: np.ndarray | None = None):
        self._given_a = a
        super().__init__(data, config, device=device)

    @classmethod
    def from_arrays(cls, data: np.ndarray, a: np.ndarray, config=None, *,
                    device: str | torch.device = "cuda") -> "StreamingIndex":
        """A streaming index over ``data`` whose segments, drift monitor
        and closest-pair key use the projection ``a`` (d, m) given, e.g.
        the JAX family's ``a``; every segment seals through its backend's
        ``from_arrays``."""
        return cls(data, config, device=device, a=a)

    # -- construction ----------------------------------------------------

    def _build(self) -> None:
        opts = self.config.options
        self.delta_threshold = int(opts.get("delta_threshold", 512))
        # a quant request flips the default segment backend to "flat",
        # whose verify tier holds the codes
        default_segment = "flat" if opts.get("quant") else "pmtree"
        self.segment_backend = str(opts.get("segment_backend",
                                            default_segment))
        if opts.get("quant") and self.segment_backend not in ("flat",
                                                              "flat-pq"):
            raise ValueError(
                f"segment_backend {self.segment_backend!r} cannot honor "
                "quantized segments; use 'flat' or 'flat-pq'")
        self.max_segments = int(opts.get("max_segments", 4))
        self.max_dead_fraction = float(opts.get("max_dead_fraction", 0.5))
        self._force = None if opts.get("use_kernels", True) else "plain"
        if self.delta_threshold < 1:
            raise ValueError("delta_threshold must be >= 1")
        if self.max_segments < 2:
            raise ValueError("max_segments must be >= 2")

        if self._given_a is not None:
            self._a = np.array(self._given_a, dtype=np.float32)
            if self._a.shape != (self.d, self.config.m):
                raise ValueError(f"a is {self._a.shape}, expected "
                                 f"({self.d}, {self.config.m})")
        else:
            self._a = ProjectionFamily.from_seed(self.d, self.config.m, self.config.seed,
                                                 device="cpu").a.numpy()

        self._store = np.empty((0, self.d), dtype=np.float32)
        self._alive = np.empty((0,), dtype=bool)
        self._owner = np.empty((0,), dtype=np.int64)  # -1 delta, else serial
        self._total = 0  # ids ever assigned == rows used in the store
        self._n_live = 0
        self.delta = DeltaBuffer(self.d, self.device)
        self.segments: list[Segment] = []
        self._by_serial: dict[int, Segment] = {}
        self.n_flushes = 0
        self.n_compactions = 0
        # projection-drift monitor (obs.drift): inserted rows feed the
        # projected-coordinate moments (host-side matmul against A), and
        # the per-segment fan-out feeds the select survivor counts into
        # the occupancy histogram
        self.drift = None
        if bool(opts.get("drift", True)):
            from ..obs.drift import DriftMonitor

            self.drift = DriftMonitor(
                baseline_rows=int(opts.get("drift_baseline", 256)))
        # durability: WAL-before-memory logging + atomic snapshots,
        # attached BEFORE the seed insert so seed rows are logged too.  A
        # dir that already holds a durable index must go through
        # resilience.recover(), not a fresh build.
        self.durability = None
        dur = opts.get("durability")
        if dur:
            from ..resilience.recovery import DurabilityManager

            self.durability = DurabilityManager(
                dur["dir"], d=self.d, config=self.config, fresh=True,
                sync=bool(dur.get("sync", True)),
                snapshot_every=int(dur.get("snapshot_every", 0)),
                snapshot_keep=int(dur.get("snapshot_keep", 2)))
        if self.data.shape[0]:
            self.insert(self.data)
        # the append-only store owns the rows now
        self.data = self._store[:0]

    # for a mutable index n is the LIVE count
    @property
    def n(self) -> int:  # type: ignore[override]
        return self._n_live

    @n.setter
    def n(self, _value) -> None:
        pass

    # -- mutation --------------------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Append rows; returns their new global ids (int64, (n,)).
        Inserted points are visible to ``search`` immediately (delta
        scan); the delta is flushed once it reaches ``delta_threshold``.
        """
        x = np.atleast_2d(np.asarray(points, dtype=np.float32))
        if x.shape[-1] != self.d:
            raise ValueError(f"points have d={x.shape[-1]}, index d={self.d}")
        cnt = x.shape[0]
        if cnt == 0:
            return np.empty((0,), dtype=np.int64)
        ids = np.arange(self._total, self._total + cnt, dtype=np.int64)
        # WAL-before-memory: the record is durable before any state
        # changes, so a crash here loses nothing already acknowledged
        if self.durability is not None:
            self.durability.log_insert(self._total, x)
        chaos.hit("stream.apply")
        self._grow_to(self._total + cnt)
        self._store[ids] = x
        self._alive[ids] = True
        self._owner[ids] = -1
        self._total += cnt
        self._n_live += cnt
        self.delta.insert(ids, x)
        if self.drift is not None:
            self.drift.observe_rows(x @ self._a)
        if len(self.delta) >= self.delta_threshold:
            self.flush()
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many were live.  Ids still in the
        delta are dropped physically; sealed ids are filtered at merge
        time until compaction rebuilds their segment.  Unknown (never
        assigned) ids raise KeyError; re-deleting is a no-op.
        """
        ids = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        if ids.size and (ids[0] < 0 or ids[-1] >= self._total):
            bad = ids[(ids < 0) | (ids >= self._total)]
            raise KeyError(f"unknown ids {bad.tolist()} "
                           f"(assigned range is [0, {self._total}))")
        targets = ids[self._alive[ids]]
        if targets.size == 0:
            return 0
        if self.durability is not None:
            self.durability.log_delete(targets)
        chaos.hit("stream.apply")
        self._alive[targets] = False
        self._n_live -= int(targets.size)
        in_delta = self.delta.delete(targets)
        sealed = np.setdiff1d(targets, in_delta, assume_unique=True)
        for serial in self._owner[sealed]:
            self._by_serial[int(serial)].dead += 1
        self._maybe_compact()
        return int(targets.size)

    def flush(self) -> None:
        """Seal the delta into an immutable segment (no-op when empty)."""
        if len(self.delta) == 0:
            return
        if chaos.dropped("stream.flush"):
            return  # injected lost flush: rows stay served from delta
        # build the segment BEFORE draining so a failed build (bad
        # segment_backend, ...) leaves every live row still served; it
        # takes the delta's rows on the device, which the drain gives up
        ids = self.delta.ids
        seg = self._segment(ids, self.delta.vectors)
        if self.durability is not None:
            self.durability.log_flush()
        chaos.hit("stream.apply")
        self.delta.take()
        self._owner[ids] = seg.serial
        self._by_serial[seg.serial] = seg
        self.segments.append(seg)
        self.n_flushes += 1
        self._maybe_compact()
        if self.durability is not None:
            self.durability.maybe_snapshot(self)

    def _segment(self, ids: np.ndarray, rows: torch.Tensor) -> Segment:
        return Segment(ids, rows, self.config, self.segment_backend, a=self._a)

    # -- compaction ------------------------------------------------------

    def _maybe_compact(self) -> None:
        victims = {s.serial: s for s in self.segments
                   if s.dead_fraction > self.max_dead_fraction}
        if len(self.segments) >= self.max_segments:
            # fold the smallest runs into one, leaving the big ones be:
            # post-compaction count settles at max_segments - 1
            by_live = sorted(self.segments, key=lambda s: (s.live, s.serial))
            n_merge = len(self.segments) - self.max_segments + 2
            for s in by_live[:n_merge]:
                victims[s.serial] = s
        if victims:
            self._compact(list(victims.values()))

    def _compact(self, victims: list[Segment]) -> None:
        """Rebuild ``victims`` into one segment holding only live rows."""
        live = np.concatenate([s.ids[self._alive[s.ids]] for s in victims])
        live.sort()
        # build the replacement BEFORE dropping the victims: a failed
        # build must leave every live row still owned by a source
        seg = (self._segment(live, as_tensor(self._store[live], self.device))
               if live.size else None)
        # compaction is a deterministic consequence of the op sequence;
        # its WAL record is an audit marker and replays as a no-op
        if self.durability is not None:
            self.durability.log_compact()
        gone = {s.serial for s in victims}
        self.segments = [s for s in self.segments if s.serial not in gone]
        for serial in gone:
            del self._by_serial[serial]
        if seg is not None:
            self._owner[live] = seg.serial
            self._by_serial[seg.serial] = seg
            self.segments.append(seg)
        self.n_compactions += 1

    # -- search ----------------------------------------------------------

    def _search(self, q: np.ndarray, k: int) -> SearchResult:
        B = q.shape[0]
        stats = WorkStats()
        id_blocks, dist_blocks = [], []
        with otrace.span("stream.search", B=B, k=k,
                         segments=len(self.segments),
                         delta=len(self.delta)):
            for seg in self.segments:
                # widen by the segment's tombstone count so filtering
                # dead rows at merge time cannot starve the per-segment
                # top-k
                with otrace.span("stream.segment", serial=seg.serial,
                                 size=seg.size, dead=seg.dead,
                                 backend=self.segment_backend):
                    gids, dd, st = seg.search(q, k + seg.dead)
                id_blocks.append(gids)
                dist_blocks.append(dd)
                stats += st
                # flat segments keep their last select survivor counts
                # and budget: the drift monitor's occupancy signal
                counts = getattr(seg.index, "last_select_counts", None)
                if self.drift is not None and counts is not None:
                    self.drift.observe_survivors(
                        counts, getattr(seg.index, "last_select_budget", 0))
            with otrace.span("stream.delta", size=len(self.delta)):
                gids, dd, st = self.delta.search(q, k, force=self._force)
            id_blocks.append(gids)
            dist_blocks.append(dd)
            stats += st

            with otrace.span("stream.merge"):
                gids = np.concatenate(id_blocks, axis=1)  # (B, S) int64
                dd = np.concatenate(dist_blocks, axis=1).astype(np.float32)
                if k == 0 or gids.shape[1] == 0:
                    return SearchResult(np.empty((B, 0), np.int32),
                                        np.empty((B, 0), np.float32),
                                        stats=stats)

                # tombstones (and per-source -1 padding) applied at
                # merge time
                invalid = (gids < 0) | ~self._alive[np.maximum(gids, 0)]
                dd = np.where(invalid, np.float32(np.inf), dd)
                kk = min(k, gids.shape[1])
                vals, cols = ops.topk_smallest(as_tensor(dd, self.device), kk,
                                               force=self._force)
                vals = vals.cpu().numpy()
                cols = cols.cpu().numpy().astype(np.int64)
                merged = np.take_along_axis(gids, cols, axis=1)
                merged = np.where(np.isinf(vals), -1, merged)
        return SearchResult(merged.astype(np.int32), vals, stats=stats)

    # -- closest pair ----------------------------------------------------

    def _cp_search(self, k: int) -> CpSearchResult:
        """(c,k)-ACP over the LIVE rows: sealed runs' live rows first,
        the delta last, concatenated into ONE pair join (one γ·t·ub
        filter and one ub register over every cross-source block).
        Tombstones are masked at gather time.  The sort key is the rows'
        first projected coordinate under A, computed on the host as the
        reference computes it; the gathered rows and the key then go to
        the device (span ``stream.cp_gather``) for the join (the
        engine's ``cp.query``)."""
        from ..core.cp_fused import cp_fused_search

        with otrace.span("stream.cp_gather", segments=len(self.segments),
                         delta=len(self.delta)):
            gid = np.concatenate([s.ids[self._alive[s.ids]] for s in self.segments]
                                 + [self.delta.ids])
            if gid.size < 2:
                return CpSearchResult(np.empty((0, 2), np.int32),
                                      np.empty((0,), np.float32))
            x = self._store[gid]
            key = as_tensor(x @ self._a[:, 0], self.device)
            x = as_tensor(x, self.device)
        cfg = self.config
        r = cp_fused_search(
            x, k, m=cfg.m, c=cfg.cp_c,
            gamma=float(cfg.options.get("cp_gamma", 1.0)),
            force=self._force, key=key)
        pairs = gid[r.pairs.astype(np.int64)]
        pairs = np.stack([pairs.min(axis=1), pairs.max(axis=1)],
                         axis=1).astype(np.int32)
        return CpSearchResult(
            pairs, r.distances,
            stats=WorkStats(candidates_verified=r.pairs_verified,
                            pairs_verified=r.pairs_verified,
                            tiles_pruned=r.tiles_pruned))

    # -- durability ------------------------------------------------------

    def snapshot(self):
        """Write an atomic on-disk snapshot now and rotate the WAL
        (requires ``options={"durability": {...}}``).  Returns the
        committed snapshot directory.  Rows come from the host store:
        nothing is read back from the device."""
        if self.durability is None:
            raise RuntimeError(
                "snapshot() requires options={'durability': {'dir': ...}}")
        return self.durability.snapshot(self)

    def close(self) -> None:
        """Flush and close the WAL handle (no-op without durability)."""
        if self.durability is not None:
            self.durability.close()

    # -- introspection ---------------------------------------------------

    @property
    def segment_count(self) -> int:
        return len(self.segments)

    @property
    def delta_size(self) -> int:
        return len(self.delta)

    @property
    def total_assigned(self) -> int:
        """Ids ever assigned (monotone; tombstones included)."""
        return self._total

    def drift_report(self):
        """Current :class:`repro_torch.obs.drift.DriftReport` (None when
        the monitor is disabled via ``options={"drift": False}``)."""
        return None if self.drift is None else self.drift.report()

    def bytes_per_point(self) -> float:
        """Resident distance-storage bytes per LIVE point: sealed
        segments (possibly quantized) charge every stored row —
        tombstoned-but-uncompacted rows still occupy storage — plus the
        float32 delta, divided by the live count."""
        if self.n == 0:
            return 0.0
        seg_bytes = sum(s.bytes_per_point() * s.size for s in self.segments)
        return (seg_bytes + 4.0 * self.d * len(self.delta)) / self.n

    def raw_bytes_per_point(self) -> float:
        """Float32 bytes per live point resident in the append-only
        store, which keeps every row ever inserted (compaction rebuilds
        from it)."""
        if self.n == 0:
            return 0.0
        return 4.0 * self.d * self._total / self.n

    def live_ids(self) -> np.ndarray:
        """Global ids currently alive (ascending, int64)."""
        return np.flatnonzero(self._alive[: self._total]).astype(np.int64)

    def get_vectors(self, ids) -> np.ndarray:
        """Rows of the append-only store for ``ids`` (alive or not)."""
        return self._store[np.asarray(ids, dtype=np.int64)].copy()

    def _grow_to(self, need: int) -> None:
        cap = self._store.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2, 1024)
        store = np.empty((new, self.d), dtype=np.float32)
        store[:cap] = self._store[:cap]
        alive = np.zeros((new,), dtype=bool)
        alive[:cap] = self._alive
        owner = np.full((new,), -1, dtype=np.int64)
        owner[:cap] = self._owner
        self._store, self._alive, self._owner = store, alive, owner

    def __repr__(self) -> str:
        return (f"StreamingIndex(n={self.n}, d={self.d}, "
                f"segments={self.segment_count}, delta={self.delta_size}, "
                f"flushes={self.n_flushes}, "
                f"compactions={self.n_compactions})")
