"""The sharded fused ANN / CP engine over a data mesh, the counterpart of
``repro.core.sharded`` (the ``sharded-flat`` and ``sharded-flat-pq``
backends).

ANN: the points are split by rows over P shards.  Five stages:

  estimate   each shard's slice of the projected distances, through the
             pairwise kernel (the flat index's own estimate, so each
             element is the float the flat index computes), its padding
             rows set to +inf;
  threshold  one global τ by a 32-rung bisection on the int32 bit
             pattern of the float32 distances (non-negative floats order
             like their bits): each rung exchanges only a psum of (B,)
             int32 survivor counts, and the bracket stays on the device;
             32 rungs pin τ to the exact T-th smallest distance;
  compact    each shard compacts its survivors d ≤ τ in row order
             (cumsum and a left searchsorted);
  verify     the verify kernel on the shard's rows into a local top-k_l
             (``sharded-flat-pq`` first reranks the survivors by ADC on
             the shard's own PQ codebook and keeps the best R_l);
  merge      one all-gather of k_l per shard and the top-k of the pool.

The candidate set is the flat index's top-T whenever the T-th and
(T+1)-th smallest projected distances differ, so the answer is the flat
index's bit for bit.

CP: the rows are sorted by the first projected coordinate and split
into key-contiguous blocks.  Round 0 is each shard's self-join; rounds
1..P−1 pass the blocks around a ring (shard p receives from p − 1) and
join own × received.  Each round is a dense masked (nl × nl) join that
skips a (tile × tile) pair tile when its key gap satisfies gap² >
thresh2 · ub², against one global ub² gathered again between rounds.
The winners are re-verified in the difference form on the device and
stably re-sorted, as ``cp_fused_search`` does.

Each stage function is written once and run by both forms of
:class:`~repro_torch.launch.DataMesh`: the emulated mesh, where one
process holds every block, and a process group, one rank a shard.
Every ``lax.top_k`` of the reference is a lowest-index selection here.
The blocks go to the device once, at build (the CP layout at the first
``cp_query``); a query uploads only its rows and reads back the ids,
the counts and the CP winners.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.merge import merge_topk
from ..launch.mesh import DataMesh, make_data_mesh
from ..launch.sharding import index_row_split, shard_rows
from ..obs import roofline
from ..obs import trace as otrace
from .estimator import solve_parameters
from .hashing import ProjectionFamily

__all__ = ["ShardedFlatIndex", "BISECT_ROUNDS", "pad_rows", "kernel_force"]

#: bisection rungs on the int32 bit pattern of non-negative float32
#: values: 32 cover the whole range, pinning τ to an exact ulp
BISECT_ROUNDS = 32

_INF = float("inf")


def kernel_force(force: str | None) -> str | None:
    """The kernels' dispatch from a backend's ``force`` option: "ref"
    (the reference's name) or "plain" select the plain versions."""
    if force in (None, "plain", "ref"):
        return None if force is None else "plain"
    raise ValueError(f"force must be None, 'ref' or 'plain', got {force!r}")


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def pad_rows(arr: np.ndarray, shards: int, fill: float = 0.0,
             multiple: int = 1) -> np.ndarray:
    """Pad (n, ...) so that every shard gets the same whole row count
    (optionally a multiple of the CP tile).  Padding rows are benign
    fill: every consumer masks by global id < n."""
    nl = shard_rows(arr.shape[0], shards, multiple)
    pad = nl * shards - arr.shape[0]
    if pad == 0:
        return np.asarray(arr)
    filler = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([np.asarray(arr), filler])


def pad_tensor(t: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    """``t`` (n, ...) padded with ``fill`` rows up to ``rows`` rows."""
    pad = rows - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])


def local_blocks(mesh: DataMesh, t: torch.Tensor) -> list[torch.Tensor]:
    """The rows of the padded ``t`` (P·nl, ...) that this process's shards
    hold: views when emulated, a copy of its own block in a group (so
    that the whole array can be freed)."""
    split = index_row_split(t.shape[0], mesh.size)
    blocks = [t[split[p]] for p in mesh.local]
    return blocks if mesh.emulated else [b.clone() for b in blocks]


def gather_rows(mesh: DataMesh, full: torch.Tensor | None, block: torch.Tensor | None,
                nl: int, gids: torch.Tensor) -> torch.Tensor:
    """Rows ``gids`` (any shape, ids < P·nl, negatives read row 0) of a
    row-split array: from the whole array (``full``, P·nl rows) when
    emulated; in a group from the one rank whose ``block`` holds each
    row, the others adding zeros, so the psum is exact."""
    gids = torch.clamp_min(gids.to(torch.int64), 0)
    if mesh.emulated:
        return full[gids]
    lo = mesh.rank * nl
    own = (gids >= lo) & (gids < lo + nl)
    rows = block[torch.clamp(gids - lo, 0, nl - 1)]
    return mesh.psum([torch.where(own[..., None], rows, 0.0)])


# ---------------------------------------------------------------------------
# ANN stage math, shared by both forms of the mesh
# ---------------------------------------------------------------------------


def _estimate_block(proj_blk, qp, gid0: int, n_valid: int, force):
    """A shard's slice of the projected squared distances, through the
    pairwise kernel (the flat estimate's norm trick, clamped at 0), its
    padding rows set to +inf."""
    d2p = kops.pairwise_sq_dist(qp, proj_blk, force=force)
    if gid0 + proj_blk.shape[0] > n_valid:
        d2p[:, max(n_valid - gid0, 0):] = _INF
    return d2p


def _row_max(d2p):
    return torch.where(torch.isfinite(d2p), d2p, 0.0).amax(1)


def _count_le_bits(d2p, tau_bits):
    """Per-row survivor count under the float32 whose bits are
    ``tau_bits``: what each bisection rung exchanges."""
    tau = tau_bits.view(torch.float32)
    return (d2p <= tau[:, None]).sum(1, dtype=torch.int32)


def _bisect_mid(lo, hi):
    return lo + (hi - lo) // 2  # hi ≥ lo: floor division of a non-negative


def _bisect_step(lo, hi, global_count, T: int):
    """One rung: shrink the integer bracket toward the least bits whose
    global survivor count reaches T."""
    mid = _bisect_mid(lo, hi)
    ge = global_count >= T
    return torch.where(ge, lo, mid), torch.where(ge, mid, hi)


def threshold(mesh: DataMesh, d2ps: list, T: int) -> torch.Tensor:
    """The global τ (B,) float32: the T-th smallest projected distance
    over every shard, by BISECT_ROUNDS rungs with no host read."""
    hi = mesh.pmax([_row_max(d) for d in d2ps]).view(torch.int32)
    lo = torch.full_like(hi, -1)
    for _ in range(BISECT_ROUNDS):
        mid = _bisect_mid(lo, hi)
        lo, hi = _bisect_step(lo, hi, mesh.psum([_count_le_bits(d, mid) for d in d2ps]), T)
    return hi.view(torch.float32)


def _compact_block(d2p, tau, cap: int):
    """A shard's survivors (d2p ≤ τ) in ``cap`` slots of local
    positions, −1 padded, in row order; and its per-row count."""
    B, nl = d2p.shape
    mask = d2p <= tau[:, None]
    cnt = mask.sum(1, dtype=torch.int32)
    cs = torch.cumsum(mask, 1, dtype=torch.int32)
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=d2p.device)
    g = torch.searchsorted(cs, ranks.expand(B, cap).contiguous(), right=False)
    cand = torch.where(g < nl, torch.clamp_max(g, nl - 1), -1).to(torch.int32)
    return cand, cnt


def _rerank_block(codes_blk, codec, q, cand, R: int, force):
    """``sharded-flat-pq``'s shard-local tier: ADC on the shard's own
    codebook, the best R survivors kept (ties to the earliest slot)."""
    lut = codec.lookup_tables(q)
    codes_c = codes_blk[torch.clamp_min(cand, 0).to(torch.int64)]  # (B, cap, S)
    adc = kops.adc_dist(codes_c, lut, force=force)
    adc = torch.where(cand < 0, _INF, adc)
    _, rsel = kref.topk_smallest(adc, R)
    return torch.gather(cand, 1, rsel.to(torch.int64))


# ---------------------------------------------------------------------------
# CP stage math
# ---------------------------------------------------------------------------


def _join_block(a, b, ub2, *, k: int, n_valid: int, thresh2: float, tile: int, force):
    """Dense masked join of two key-sorted blocks (pts, norm, key, sgid)
    under tile-level radius pruning: a (tile × tile) pair tile whose key
    gap satisfies gap² > thresh2 · ub² cannot hold a top-k pair (the key
    gap bounds every pair's projected gap), so it is masked out and
    counted pruned.  Valid pairs are sgid_a < sgid_b, which makes the
    self-join upper-triangular and counts each cross pair on one shard.

    Returns (top-k d² ascending (k,), sgid_i, sgid_j, pairs_verified,
    tiles_pruned).  The (nl × nl) temporaries are freed on return."""
    a_pts, a_norm, a_key, a_sgid = a
    b_pts, b_norm, b_key, b_sgid = b
    nl = a_pts.shape[0]
    nt = nl // tile
    cross = a_pts @ b_pts.T
    d2 = a_norm[:, None] + b_norm[None, :]
    d2.sub_(cross.mul_(2.0))
    del cross
    d2.clamp_min_(0.0)
    pv = ((a_sgid[:, None] < n_valid) & (b_sgid[None, :] < n_valid)
          & (a_sgid[:, None] < b_sgid[None, :]))

    # the tile filter against the global ub register
    a_kmin, a_kmax = a_key.view(nt, tile).amin(1), a_key.view(nt, tile).amax(1)
    b_kmin, b_kmax = b_key.view(nt, tile).amin(1), b_key.view(nt, tile).amax(1)
    gap = torch.maximum(torch.maximum(b_kmin[None, :] - a_kmax[:, None],
                                      a_kmin[:, None] - b_kmax[None, :]),
                        torch.zeros((), device=a_key.device))
    prune = (gap * gap) > (thresh2 * ub2)  # (nt, nt)
    pv4 = pv.view(nt, tile, nt, tile)
    tiles_pruned = (prune & pv4.any(3).any(1)).sum()
    pv4 &= ~prune[:, None, :, None]  # the pairs the join uses
    pairs_verified = pv.sum()
    d2.masked_fill_(~pv, _INF)
    del pv, pv4
    kb = min(k, nl * nl)  # a block pair holds at most nl² pairs
    vals, idx = kops.topk_smallest(d2.view(1, -1), kb, force=force)
    del d2
    idx = idx[0].to(torch.int64)
    d_out, i_out, j_out = vals[0], a_sgid[idx // nl], b_sgid[idx % nl]
    if kb < k:  # pad to the pool width; +inf entries merge away
        pad = k - kb
        d_out = torch.cat([d_out, d_out.new_full((pad,), _INF)])
        i_out = torch.cat([i_out, i_out.new_zeros(pad)])
        j_out = torch.cat([j_out, j_out.new_zeros(pad)])
    return d_out, i_out, j_out, pairs_verified, tiles_pruned


def _global_ub2(mesh: DataMesh, best: list, k: int) -> torch.Tensor:
    """ub² = the k-th best pair d² over every shard's running top-k."""
    pool = torch.cat(mesh.all_gather([b[0] for b in best]))
    return torch.sort(pool).values[k - 1]


def _top_pairs(d, i, j, k: int):
    """The k smallest of a pair pool, ties to the earliest slot."""
    vals, sel = kref.topk_smallest(d[None], k)
    sel = sel[0].to(torch.int64)
    return vals[0], i[sel], j[sel]


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Shard:
    """One shard's device blocks: rows, projection, and for pq its codec
    and codes."""

    p: int
    data: torch.Tensor
    proj: torch.Tensor
    codec: object = None
    codes: torch.Tensor | None = None


class ShardedFlatIndex:
    """Row-sharded fused PM-LSH index (ANN + CP + optional per-shard PQ).

    Args:
      data: (n, d) float32 points (host).
      shards: shard count P of an emulated mesh (default: the default
        process group's size where one is initialised, else 1).
      mesh: a :class:`DataMesh` to run over (its device is the index's).
      m / seed / c: projection size, seed and ANN ratio, as
        ``build_flat_index``.
      emulate: run the emulated mesh of ``shards`` even where a default
        process group is initialised.
      quant: None or "pq": per-shard PQ codebooks and a shard-local ADC
        rerank tier (the raw rows stay for exact verification).
      quant_opts: codec options (e.g. ``{"m_codebooks": 8}``).
      rerank: rerank budget R (None: max(4k, T/3, 64), flat-pq's).
      force: "ref" (or "plain") runs the kernels' plain versions.
      cp_tile: the CP join's tile side.
      device: the emulated mesh's device; the default, the card, raises
        where CUDA is absent.
      a / projected / codecs / codes: given arrays (see ``from_arrays``).
    """

    def __init__(self, data, *, shards: int | None = None, mesh: DataMesh | None = None,
                 m: int = 15, seed: int = 0, c: float = 1.5, axis: str = "data",
                 emulate: bool = False, quant: str | None = None,
                 quant_opts: dict | None = None, rerank: int | None = None,
                 force: str | None = None, cp_tile: int = 128,
                 device: str | torch.device = "cuda", a: np.ndarray | None = None,
                 projected: np.ndarray | None = None, codecs: list | None = None,
                 codes: np.ndarray | None = None):
        data = np.asarray(data, np.float32)
        self.n, self.d = data.shape
        self.seed = int(seed)
        self.force = kernel_force(force)
        self.rerank = rerank
        self.cp_tile = int(cp_tile)
        if mesh is not None:
            if emulate and not mesh.emulated:
                raise ValueError("emulate=True with a process-group mesh")
        elif emulate:
            mesh = DataMesh(size=int(shards) if shards is not None else 1,
                            device=resolve_device(device), axis=axis)
        else:
            mesh = make_data_mesh(shards, axis, device=device)
        self.mesh = mesh
        self.P = mesh.size
        self.device = dev = mesh.device
        self._data_h = data

        self.family = (ProjectionFamily.from_seed(self.d, m, self.seed, dev) if a is None
                       else ProjectionFamily.from_numpy(a, dev))
        self.m = self.family.m
        self.params = solve_parameters(c, m=self.m)
        data_t = as_tensor(data, dev)
        proj = self.family.project(data_t) if projected is None else as_tensor(projected, dev)
        if tuple(proj.shape) != (self.n, self.m):
            raise ValueError(f"projected {tuple(proj.shape)} for n={self.n}, m={self.m}")
        self._key_h = proj[:, 0].cpu().numpy()  # the CP sort key
        self.nl = nl = shard_rows(self.n, self.P)
        data_p = pad_tensor(data_t, self.P * nl, 0.0)
        data_b = local_blocks(mesh, data_p)
        proj_b = local_blocks(mesh, pad_tensor(proj, self.P * nl, 0.0))
        # the emulated mesh keeps the whole padded array (its blocks are
        # views of it) for the answer's row lookups
        self._data_full = data_p if mesh.emulated else None
        del data_t, data_p, proj
        self._shards = [_Shard(p, x, y) for p, x, y in zip(mesh.local, data_b, proj_b)]

        self.codecs = None
        self.codebook_bytes = 0
        if quant is not None:
            if quant != "pq":
                raise ValueError(f"sharded quant tier supports 'pq', got {quant!r}")
            self._shard_codecs(dict(quant_opts or {}), codecs, codes)
        self._cp = None  # the key-sorted CP layout, built at the first cp_query

    @classmethod
    def from_arrays(cls, data, a: np.ndarray, projected: np.ndarray | None = None, *,
                    codecs: list | None = None, codes: np.ndarray | None = None,
                    **kwargs) -> "ShardedFlatIndex":
        """An index over ``data`` with the projection A given (e.g. the
        JAX index's ``family.a``) and, optionally, its float32
        ``projected`` rows; a pq index also takes each shard's codec
        (``convert.codec_from_arrays``) and the (P, nl, S) codes, e.g.
        the JAX index's ``codecs`` and ``_codes_blocks``."""
        quant = kwargs.pop("quant", None)
        return cls(data, a=a, projected=projected, codecs=codecs, codes=codes,
                   quant="pq" if codecs is not None else quant, **kwargs)

    # -- build helpers ----------------------------------------------------

    def _shard_codecs(self, opts: dict, codecs, codes) -> None:
        """One PQ codec per shard, trained on the rows it encodes (seed
        + p); S depends only on d, V may shrink on a small tail shard."""
        from ..quant.codec import train_pq

        opts.setdefault("m_codebooks", 16)
        for s in self._shards:
            if codecs is not None:
                s.codec = codecs[s.p]
            else:
                valid = min(self.nl, max(self.n - s.p * self.nl, 0))
                rows = (self._data_h[s.p * self.nl:s.p * self.nl + valid] if valid
                        else np.zeros((1, self.d), np.float32))
                s.codec = train_pq(rows, seed=self.seed + s.p, device=self.device, **opts)
            s.codes = (s.codec.encode(s.data) if codes is None else torch.from_numpy(
                np.array(codes[s.p], dtype=np.uint8)).to(self.device))
        self.codecs = [s.codec for s in self._shards]
        local = [torch.tensor([s.codec.codebook_bytes], dtype=torch.int64, device=self.device)
                 for s in self._shards]
        self.codebook_bytes = int(self.mesh.psum(local).item())

    def _cp_layout(self):
        """Rows sorted stably by the key, padded (data 0, keys +inf) to a
        multiple of the tile, each local block on the device once."""
        if self._cp is not None:
            return self._cp
        P = self.P
        order = np.argsort(self._key_h, kind="stable")
        tile = max(1, min(self.cp_tile, -(-self.n // P)))
        split = index_row_split(self.n, P, tile)
        xs = pad_rows(self._data_h[order], P, multiple=tile)
        ks = pad_rows(self._key_h[order].reshape(-1, 1), P, fill=np.inf,
                      multiple=tile).reshape(-1)
        blocks = []
        for p in self.mesh.local:
            rows = split[p]
            pts = as_tensor(xs[rows], self.device)
            blocks.append((pts, (pts * pts).sum(-1), as_tensor(ks[rows], self.device),
                           torch.arange(rows.start, rows.stop, dtype=torch.int32,
                                        device=self.device)))
        nl = split[0].stop
        self._cp = {"order": torch.from_numpy(order).to(self.device), "nl": nl,
                    "tile": tile, "blocks": blocks}
        return self._cp

    # -- ANN --------------------------------------------------------------

    def rerank_budget(self, k: int, T: int) -> int:
        rerank = self.rerank if self.rerank is not None else max(4 * k, T // 3, 64)
        return min(max(int(rerank), k), T)

    def query(self, q: torch.Tensor, k: int, T: int):
        """Batched (c,k)-ANN of q (B, d) on the index's device.  Returns
        (ids (B, k) int32, the merge's distances (B, k) float32, counts
        (P, B) int32 per-shard survivor counts), on the device.

        While tracing, the stages run under ``shard.*`` spans, as the
        reference's traced twin; the estimate's kernel records no span
        of its own there (the reference's estimate is inline jnp)."""
        mesh, nl = self.mesh, self.nl
        q = q.to(device=self.device, dtype=torch.float32)
        B = q.shape[0]
        cap = min(nl, T)  # a shard holds at most min(nl, T) survivors
        pq = self.codecs is not None
        R_l = min(self.rerank_budget(k, T), cap) if pq else cap
        k_l = min(k, R_l)  # k > per-shard n: the local answer shrinks
        with otrace.span("shard.query", P=self.P, B=B, n=self.n, k=k, T=T):
            qp = self.family.project(q)
            with otrace.span("shard.estimate"):
                with otrace.paused():
                    d2ps = [_estimate_block(s.proj, qp, s.p * nl, self.n, self.force)
                            for s in self._shards]
                otrace.block(d2ps)
            with otrace.span("shard.select", rounds=BISECT_ROUNDS) as s_sel:
                tau = threshold(mesh, d2ps, T)
                compacted = [_compact_block(d, tau, cap) for d in d2ps]
                otrace.block(compacted)
            del d2ps
            exchange = roofline.shard_exchange_cost(self.P, B, k_l, rounds=BISECT_ROUNDS)
            with otrace.span("shard.exchange", **exchange.attrs()):
                counts = otrace.block(torch.stack(mesh.all_gather([c for _, c in compacted])))
            if s_sel is not None:  # a host read, only while tracing
                s_sel.attrs["candidates_selected"] = int(counts.sum())
            with otrace.span("shard.verify"):
                d2s, gids = [], []
                for s, (cand, _) in zip(self._shards, compacted):
                    if pq:
                        cand = _rerank_block(s.codes, s.codec, q, cand, R_l, self.force)
                    d2l, locl = kops.verify_topk(s.data, q, cand, k_l, force=self.force)
                    d2s.append(d2l)
                    gids.append(torch.where(locl >= 0, locl + s.p * nl, -1))
                otrace.block(d2s, gids)
            with otrace.span("shard.merge",
                             **roofline.shard_merge_cost(self.P, B, k_l).attrs()):
                ids, dd = merge_topk(torch.cat(mesh.all_gather(d2s), 1),
                                     torch.cat(mesh.all_gather(gids), 1), k)
                otrace.block(ids, dd)
        return ids, dd, counts

    def rows(self, gids: torch.Tensor) -> torch.Tensor:
        """Rows of the original data by id, from the shards' blocks."""
        return gather_rows(self.mesh, self._data_full, self._shards[0].data, self.nl, gids)

    def answer_distances(self, ids: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """The canonical answer floats, ``flat_index.answer_distances``'s
        arithmetic on the same rows: ||q_b − x||, +inf where id < 0."""
        rows = self.rows(ids)
        d2 = ((rows - q[:, None, :]) ** 2).sum(-1)
        d2 = torch.where(ids < 0, _INF, d2)
        return torch.sqrt(torch.clamp_min(d2, 0.0))

    # -- CP ---------------------------------------------------------------

    def cp_query(self, k: int, *, thresh2: float):
        """(c,k)-ACP by the ring join.  Returns (pairs (k', 2) int32 ids
        i < j ascending by exact distance, distances (k',) float32,
        pair_counts (P,) int64 per-shard pairs verified, tiles_pruned)."""
        k = int(k)
        kk = min(k, self.n * (self.n - 1) // 2)
        if kk == 0:
            return (np.empty((0, 2), np.int32), np.empty((0,), np.float32),
                    np.zeros((self.P,), np.int64), 0)
        lay = self._cp_layout()
        mesh, nl, tile, blocks = self.mesh, lay["nl"], lay["tile"], lay["blocks"]
        dev = self.device
        join = dict(k=kk, n_valid=self.n, thresh2=float(thresh2), tile=tile, force=self.force)
        with otrace.span("shard.cp", P=self.P, n=self.n, k=kk):
            best, pv_cnt, tp_cnt = [], [], []
            no_ub = torch.tensor(_INF, device=dev)
            with otrace.span("shard.verify", round=0):
                for blk in blocks:  # round 0: each shard's self-join, no ub yet
                    with otrace.paused():
                        d, i, j, pv, tp = _join_block(blk, blk, no_ub, **join)
                    best.append((d, i, j))
                    pv_cnt.append(pv)
                    tp_cnt.append(tp)
                otrace.block(best)
            ub2 = _global_ub2(mesh, best, kk)
            recv = list(blocks)
            ring = roofline.shard_ring_cost(self.P, nl, self.d, kk)
            for r in range(1, self.P):
                with otrace.span("shard.exchange", round=r, **ring.attrs()):
                    recv = otrace.block(mesh.ring(recv))
                with otrace.span("shard.verify", round=r):
                    for x, (blk, got) in enumerate(zip(blocks, recv)):
                        with otrace.paused():
                            d, i, j, pv, tp = _join_block(blk, got, ub2, **join)
                        b = best[x]
                        best[x] = _top_pairs(torch.cat([b[0], d]), torch.cat([b[1], i]),
                                             torch.cat([b[2], j]), kk)
                        pv_cnt[x] = pv_cnt[x] + pv
                        tp_cnt[x] = tp_cnt[x] + tp
                    otrace.block(best)
                ub2 = _global_ub2(mesh, best, kk)
            del recv
            with otrace.span("shard.merge", **roofline.shard_merge_cost(self.P, 1, kk).attrs()):
                fd, fi, fj = _top_pairs(*(torch.cat(mesh.all_gather([b[x] for b in best]))
                                          for x in range(3)), kk)
                fd, fi, fj = otrace.block(fd, fi, fj)
            pair_counts = torch.cat(mesh.all_gather([c.reshape(1) for c in pv_cnt]))
            tiles_pruned = mesh.psum([c.reshape(1) for c in tp_cnt])

        # re-verification, as cp_fused_search: sorted positions back to
        # ids, the winners in the difference form, a stable re-sort; one
        # host read brings everything back
        real = torch.isfinite(fd) & (fi >= 0)
        ids_a, ids_b = lay["order"][torch.clamp(torch.stack([fi, fj]).to(torch.int64), 0,
                                                self.n - 1)]
        pairs = torch.stack([torch.minimum(ids_a, ids_b), torch.maximum(ids_a, ids_b)], 1)
        diff = self.rows(pairs[:, 0]) - self.rows(pairs[:, 1])
        dists = torch.where(real, torch.sqrt((diff * diff).sum(1)), float("nan"))
        resort = torch.sort(dists, stable=True).indices
        host = torch.cat([pairs[resort].reshape(-1),
                          dists[resort].view(torch.int32).to(torch.int64),
                          pair_counts.to(torch.int64), tiles_pruned.to(torch.int64),
                          real.sum().reshape(1)]).cpu().numpy()
        m = int(host[-1])
        P = self.P
        return (host[:2 * kk].reshape(kk, 2)[:m].astype(np.int32),
                host[2 * kk:3 * kk].astype(np.int32).view(np.float32)[:m],
                host[3 * kk:3 * kk + P].astype(np.int64), int(host[3 * kk + P]))
