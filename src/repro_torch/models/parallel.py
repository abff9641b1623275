"""Tensor, expert and sequence parallelism over the mesh's 'model' axis:
the layouts of ``launch.sharding.param_pspecs`` executed.

The reference only declares its layouts and lets GSPMD insert every
collective; here each block runs them itself, Megatron's way.  One
:class:`Shard` is one data shard's view of the model axis: the model
shards it runs (every one when emulated, the rank's own in a group), the
per-layer layouts of the parameters, whether the residual is split on
the sequence (SP) and the MoE's :class:`~.moe.DataRoute`.

  column-parallel   q / k / v, the MLP's gate / up / in, the RG-LRU's
                    x / y branches: each shard multiplies the whole input
                    by its block of columns (its heads, its channels);
  row-parallel      o, down, out: each shard contracts its block of rows
                    and the partial outputs are summed over 'model';
  vocabulary        the embedding masks the ids outside its rows and the
                    rows are summed; the head's logits stay split, and the
                    loss takes the log-sum-exp from a max and a sum of
                    exponentials over 'model';
  experts           each shard runs E/M experts on the dispatch rows
                    routed to them (routing, capacity and positions are
                    the global ones of ``moe.route``);
  SP                between blocks the residual (B, S, d) is held as M
                    blocks of S/M rows; an all-gather goes before a
                    column-parallel input and a reduce-scatter takes the
                    place of the row-parallel sum.

A column block that does not match the work a shard does (a quarter
head, the mLSTM's [z | gate] halves, a leaf the divisibility guard
replicated, a layer held whole by another shard) is gathered over
'model' first.  A block whose work does not divide the axis (heads,
channels or experts not a multiple of M; the xLSTM blocks) runs whole on
every shard and only shard 0's output enters the sum, so that every
shard still runs the same collectives forward and backward.

Forms.  Emulated, the parameters and caches are whole tensors and each
model shard takes its block as a contiguous copy of a slice, every
shard in turn inside each block; the sums are in shard order.  In a
group (gloo on the CPU, NCCL on the card) each rank holds its blocks and
the collectives are autograd functions: identity forward and a sum over
'model' backward (``_Copy``), the sum forward and identity backward
(``_Reduce``), an all-gather paired with a reduce-scatter (``_Gather``,
``_Scatter``), and a broadcast from a layer's owner (``_Broadcast``).
FSDP's split over 'data' is an all-gather of the leaf before use whose
backward reduce-scatters the gradient (the data-parallel sum).  Every
float sum is added in shard order (``DataMesh.ordered_sum``), so the
two forms give the same bits.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.autograd import Function

from . import layers as L
from .lsh_attention import lsh_decode_attention, lsh_decode_attention_sharded
from .moe import route as moe_route
from .recurrent import _block_diag_apply, _causal_conv1d, _rglru_scan
from .xlstm import mlstm_block_apply, slstm_block_apply

__all__ = ["Shard", "attention", "cross_attention", "embed", "forward", "gelu_mlp",
           "loss_fn", "moe", "rglru", "swiglu", "vocab_logits", "whisper_decode_step",
           "whisper_forward", "whisper_loss_fn"]


# ---------------------------------------------------------------------------
# the group form's collectives, as autograd functions
# ---------------------------------------------------------------------------


class _Copy(Function):
    """Identity forward; the gradient summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, am):
        ctx.am = am
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.am.ordered_sum([g.contiguous()]), None


class _Reduce(Function):
    """The sum over the axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, am):
        return am.ordered_sum([x.contiguous()])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(Function):
    """All-gather along ``dim`` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, am, dim):
        ctx.am, ctx.dim = am, dim
        return torch.cat(am.all_gather([x.contiguous()]), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.am.reduce_scatter([g.contiguous()], ctx.dim)[0].contiguous(), None, None


class _Scatter(Function):
    """Reduce-scatter along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, am, dim):
        ctx.am, ctx.dim = am, dim
        return am.reduce_scatter([x.contiguous()], dim)[0].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.am.all_gather([g.contiguous()]), dim=ctx.dim), None, None


class _Broadcast(Function):
    """The ``owner``'s tensor forward (the others hold an empty
    placeholder); the gradient summed to the owner backward."""

    @staticmethod
    def forward(ctx, x, am, owner, shape):
        ctx.am, ctx.owner, ctx.like = am, owner, x
        return am.broadcast(x, owner, shape)

    @staticmethod
    def backward(ctx, g):
        total = ctx.am.ordered_sum([g.contiguous()])
        mine = total if ctx.am.rank == ctx.owner else torch.zeros_like(ctx.like)
        return mine, None, None, None


class _Fan(Function):
    """The emulated form's counterpart of ``_Copy``: n aliases of x, one a
    shard, whose gradients are added in shard order backward (as a
    group's sum over ranks adds them), not in autograd's order."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        out = None
        for g in gs:
            if g is not None:
                out = g if out is None else out + g
        return out, None


def _names(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# one data shard's view of the model axis
# ---------------------------------------------------------------------------


class Shard:
    """The model axis as one data shard runs it.

    ``layouts`` ({name: ``LeafLayout``}, ``launch.sharding.layer_layouts``)
    and ``params`` (the module whose ``named_parameters()`` they name)
    say how each leaf lies; an emulated mesh reads whole tensors and
    needs neither.  ``sp``: the residual is split on the sequence.
    ``data_route``: the MoE's global routing (``moe.DataRoute``)."""

    def __init__(self, mesh, *, layouts: dict | None = None, params=None, sp: bool = False,
                 data_route=None):
        self.mesh, self.mm = mesh, mesh.model
        self.M, self.local = self.mm.size, self.mm.local
        self.emulated = mesh.emulated
        self.mrank = None if self.emulated else mesh.coords[1]  # this rank's model shard
        self.sp, self.data_route = sp, data_route
        self._lay = {}
        if not self.emulated:
            if layouts is None or params is None:
                raise ValueError("a process group's shard needs the layouts and the module")
            self._lay = {id(t): layouts[n] for n, t in params.named_parameters()}

    # -- work split --------------------------------------------------------

    def split(self, n: int, m: int) -> tuple[tuple[int, int], bool]:
        """((lo, hi), counts): shard m's block of n (even blocks where the
        axis divides n; else all of it, and only shard 0's result counts)."""
        if n % self.M == 0:
            b = n // self.M
            return (m * b, (m + 1) * b), True
        return (0, n), m == 0

    def skip(self, counts: bool) -> bool:
        """Whether a shard whose result does not count need not run: when
        emulated (no collective waits for it)."""
        return self.emulated and not counts

    def counted(self, out: torch.Tensor, counts: bool) -> torch.Tensor:
        """``out`` if it enters the sum, else zeros with its graph kept
        (so every rank of a group runs the same backward collectives)."""
        return out if counts else out.masked_fill(torch.ones((), dtype=torch.bool,
                                                             device=out.device), 0)

    # -- parameters --------------------------------------------------------

    def shape(self, w: torch.Tensor) -> tuple[int, ...]:
        """The whole leaf's shape."""
        lay = self._lay.get(id(w))
        return tuple(w.shape) if lay is None else lay.shape

    def held(self, w: torch.Tensor) -> torch.Tensor:
        """The leaf as this process works with it: whole when emulated;
        in a group the rank's block over 'model' after FSDP's gather over
        'data' and a layer owner's broadcast."""
        lay = self._lay.get(id(w))
        if lay is None:
            return w
        t = w
        if lay.layer_axes is not None and self.mesh.axis(lay.layer_axes).size > 1:
            t = _Broadcast.apply(t, self.mesh.axis(lay.layer_axes), lay.owner,
                                 lay.local_shape(self.mesh))
        for dim, e in enumerate(lay.spec):
            if e is not None and "model" not in _names(e):
                t = _Gather.apply(t, self.mesh.data, dim)
        return t

    def part(self, w: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
        """Rows or columns [lo, hi) along ``dim`` of the whole leaf, for
        use in one shard's share of the work: the rank's own block where
        it is exactly that, else gathered over 'model' (a replicated leaf:
        its gradient summed over 'model' backward) and sliced."""
        t = w
        if not self.emulated:
            lay = self._lay.get(id(w))
            t = self.held(w)
            md = None if lay is None else lay.dim_of("model")
            if md is None and (lay is None or "model" not in _names(lay.layer_axes)):
                t = _Copy.apply(t, self.mm)  # (a broadcast over 'model' sums backward itself)
            elif md is None:
                pass
            else:
                b, m = lay.shape[md] // self.M, self.mrank
                if md == dim and (lo, hi) == (m * b, (m + 1) * b):
                    return t
                t = _Gather.apply(t, self.mm, md)
        if (lo, hi) == (0, t.shape[dim]):
            return t
        return t.narrow(dim, lo, hi - lo).contiguous()

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        return self.part(w, 0, 0, self.shape(w)[0])

    def norm_w(self, w: torch.Tensor) -> torch.Tensor:
        """A weight applied to the residual on its own rows: under SP its
        gradient is summed over 'model'."""
        if self.emulated:
            return w
        t = self.held(w)
        return _Copy.apply(t, self.mm) if self.sp else t

    # -- activations ---------------------------------------------------------

    def fan(self, x: torch.Tensor | None) -> list:
        """x as each local shard's input: one alias a shard when emulated
        (their gradients added in shard order), x itself in a group."""
        if x is None or not self.emulated or not x.requires_grad:
            return [x] * len(self.local)
        return list(_Fan.apply(x, len(self.local)))

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering the shards' work."""
        return x if self.emulated else _Copy.apply(x, self.mm)

    def enter(self, xs: list[torch.Tensor]) -> torch.Tensor:
        """The residual's blocks → the whole (B, S, d) input of a block."""
        if self.emulated:
            return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
        if self.sp:
            return _Gather.apply(xs[0], self.mm, 1)
        return _Copy.apply(xs[0], self.mm)

    def exit(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """The shards' partial outputs → the residual's blocks: summed
        over 'model' (reduce-scattered on the sequence under SP)."""
        if self.emulated:
            total = self.psum(parts)
            return list(total.chunk(self.M, dim=1)) if self.sp else [total]
        if self.sp:
            return [_Scatter.apply(parts[0], self.mm, 1)]
        return [_Reduce.apply(parts[0], self.mm)]

    def gather(self, parts: list[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' blocks concatenated along ``dim`` (no gradient)."""
        every = parts if self.emulated else self.mm.all_gather([parts[0].contiguous()])
        return torch.cat(every, dim=dim)

    def pmax(self, xs: list) -> torch.Tensor:
        """The max over 'model' of one value a local shard (``None``: a
        shard that did not run)."""
        xs = [x for x in xs if x is not None]
        out = xs[0]
        if self.emulated:
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        return self.mm.pmax([out])

    def psum(self, xs: list) -> torch.Tensor:
        """The sum over 'model', in shard order, of one value a local
        shard (``None``: a shard that did not run); identity backward."""
        xs = [x for x in xs if x is not None]
        if self.emulated:
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        return _Reduce.apply(xs[0], self.mm)


def _norm(sh: Shard, xs, w, eps):
    w = sh.norm_w(w)
    return [L.rms_norm(x, w, eps) for x in xs]


def _add(xs, ys):
    return [x + y for x, y in zip(xs, ys)]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_plan(H: int, KV: int, hd: int, M: int, m: int, all_heads: bool):
    """(q heads, kv heads, kv split, wo rows, counts) of shard m: the
    heads split over the axis where it divides them, every kv head where
    it does not divide those; else every head on every shard, each
    contracting its block of wo's rows (or shard 0 all of them)."""
    G = H // KV
    if not all_heads and H % M == 0:
        q = (m * H // M, (m + 1) * H // M)
        if KV % M == 0:
            return q, (m * KV // M, (m + 1) * KV // M), True, (q[0] * hd, q[1] * hd), True
        n = q[1] - q[0]
        if G % n == 0 or n % G == 0:
            return q, (0, KV), False, (q[0] * hd, q[1] * hd), True
    if (H * hd) % M == 0:
        b = H * hd // M
        return (0, H), (0, KV), False, (m * b, (m + 1) * b), True
    return (0, H), (0, KV), False, (0, H * hd), m == 0


def _cache_io(sh: Shard, cache: dict, kv: tuple[int, int], kv_split: bool, block: dict,
              new: dict) -> dict:
    """Write this shard's new rows into the cache and return what it
    reads (kv heads ``kv`` of k, v, pk).  Emulated: whole tensors (its
    kv block when split).  A group: its local blocks; a cache split on
    its width over 'model' takes its slice of the new rows and is read
    gathered (serving only)."""
    out = {}
    for name, t in cache.items():
        if name not in new:
            continue
        x = new[name]
        if sh.emulated:
            view = t[:, :, kv[0]:kv[1]] if kv_split else t
            L.write_rows(view, x, block.get("index", 0), **block.get("rows", {}))
            out[name] = view
            continue
        w = t.shape[-1]
        if w != x.shape[-1]:  # split on the width over 'model'
            m = sh.mrank
            L.write_rows(t, x[..., m * w:(m + 1) * w].contiguous(), block.get("index", 0),
                         **block.get("rows", {}))
            out[name] = torch.cat(sh.mm.all_gather([t.contiguous()]), dim=-1)
        else:
            L.write_rows(t, x, block.get("index", 0), **block.get("rows", {}))
            out[name] = t
    return out


def attention(p, x: torch.Tensor, cfg, sh: Shard, *, positions, cache: dict | None = None,
              cache_index=0, window: int = 0, use_lsh: bool = False, causal: bool = True,
              lsh_shard: tuple | None = None) -> list[torch.Tensor]:
    """:func:`~.layers.attention_apply` over the model axis: x is the
    whole (B, S, d) input; returns one partial output a local shard.
    The cache is written in place (its layout as ``cache_pspecs`` gives
    it: kv heads over 'model' where the axis divides them, else the
    width; the sequence over ``lsh_shard``'s axes, read as
    :func:`~.layers.attention_apply` reads it)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cache is None:
        lsh_shard = None  # as in the reference: it does nothing without a cache
    seq_model = lsh_shard is not None and "model" in _names(lsh_shard[1])
    block = {"index": cache_index}
    if lsh_shard is not None and not sh.emulated:
        am, Sl = lsh_shard[0].axis(lsh_shard[1]), cache["k"].shape[1]
        block["rows"] = {"base": am.rank * Sl, "total": am.size * Sl}
    parts = []
    for m, x in zip(sh.local, sh.fan(x)):
        (qlo, qhi), kv, kv_split, (rlo, rhi), counts = _attn_plan(H, KV, hd, sh.M, m, seq_model)
        if sh.skip(counts):
            parts.append(None)
            continue
        nq, nkv = qhi - qlo, kv[1] - kv[0]
        q = (x @ sh.part(p["wq"], 1, qlo * hd, qhi * hd)).reshape(B, S, nq, hd)
        k = (x @ sh.part(p["wk"], 1, kv[0] * hd, kv[1] * hd)).reshape(B, S, nkv, hd)
        v = (x @ sh.part(p["wv"], 1, kv[0] * hd, kv[1] * hd)).reshape(B, S, nkv, hd)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        kv_len = None
        if cache is not None:
            new = {"k": k, "v": v}
            if "pk" in cache:  # PM-LSH projected keys ride along in the cache
                a = sh.held(p["lsh_a"])
                new["pk"] = torch.einsum("bskd,dm->bskm", k.float(), a.float()).to(k.dtype)
            read = _cache_io(sh, cache, kv, kv_split, block, new)
            k_all, v_all = read["k"], read["v"]
            kv_len = cache_index + S
        else:
            k_all, v_all = k, v
        sel = (0, nkv)  # the kv heads the local q heads read
        if not kv_split and (qlo, qhi) != (0, H):
            G = H // KV
            sel = (qlo // G, (qhi - 1) // G + 1)

        def heads(t):
            return t if sel == (0, t.shape[2]) else t[:, :, sel[0]:sel[1]].contiguous()

        if use_lsh and cache is not None and S == 1:
            a = sh.held(p["lsh_a"])
            if lsh_shard is not None:
                out = lsh_decode_attention_sharded(
                    q, heads(k_all), heads(v_all), heads(read["pk"]), a, kv_len=kv_len,
                    topk=cfg.lsh_topk, mesh=lsh_shard[0], axis=lsh_shard[1])
            else:
                out = lsh_decode_attention(q, heads(k_all), heads(v_all), heads(read["pk"]), a,
                                           kv_len=kv_len, topk=cfg.lsh_topk)
        elif lsh_shard is not None and L.from_zero(cache_index):
            out = L.chunked_attention(q, heads(k), heads(v), causal=causal,
                                      q_offset=positions[0], window=window)
        elif lsh_shard is not None:
            out = L.split_cache_attention(q, heads(k_all), heads(v_all), mesh=lsh_shard[0],
                                          axis=lsh_shard[1], causal=causal,
                                          q_offset=positions[0], window=window, kv_len=kv_len)
        elif cache is None and S % min(1024, S) == 0:
            from .flash_attention import flash_attention

            out = flash_attention(q, heads(k_all), heads(v_all), causal, window)
        else:
            out = L.chunked_attention(q, heads(k_all).contiguous(), heads(v_all).contiguous(),
                                      causal=causal, q_offset=positions[0], window=window,
                                      kv_len=kv_len)
        o = out.reshape(B, S, nq * hd)[..., rlo - qlo * hd:rhi - qlo * hd]
        parts.append(sh.counted(o @ sh.part(p["wo"], 0, rlo, rhi), counts))
    return parts


def cross_attention(p, x: torch.Tensor, memory: torch.Tensor | None, cfg, sh: Shard, *,
                    cross_kv: dict | None = None) -> list[torch.Tensor]:
    """:func:`~.layers.cross_attention_apply` over the model axis: the
    queries' heads split as self-attention's; k / v from ``memory``
    (whole, the same on every shard) or the cached cross K/V."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mems = sh.fan(None if memory is None else sh.copy(memory))
    parts = []
    for m, x, mem in zip(sh.local, sh.fan(x), mems):
        (qlo, qhi), kv, kv_split, (rlo, rhi), counts = _attn_plan(H, KV, hd, sh.M, m, False)
        if sh.skip(counts):
            parts.append(None)
            continue
        nq = qhi - qlo
        q = (x @ sh.part(p["wq"], 1, qlo * hd, qhi * hd)).reshape(B, S, nq, hd)
        if cross_kv is not None:
            k, v = (_cross_read(sh, cross_kv[n], kv, kv_split, hd) for n in ("ck", "cv"))
        else:
            Mm = mem.shape[1]
            k = (mem @ sh.part(p["wk"], 1, kv[0] * hd, kv[1] * hd)).reshape(B, Mm, -1, hd)
            v = (mem @ sh.part(p["wv"], 1, kv[0] * hd, kv[1] * hd)).reshape(B, Mm, -1, hd)
        if not kv_split and (qlo, qhi) != (0, H):
            G = H // KV
            k, v = (t[:, :, qlo // G:(qhi - 1) // G + 1] for t in (k, v))
        out = L.chunked_attention(q, k.contiguous(), v.contiguous(), causal=False)
        o = out.reshape(B, S, nq * hd)[..., rlo - qlo * hd:rhi - qlo * hd]
        parts.append(sh.counted(o @ sh.part(p["wo"], 0, rlo, rhi), counts))
    return parts


def _cross_read(sh: Shard, t: torch.Tensor, kv, kv_split, hd: int) -> torch.Tensor:
    """The kv heads ``kv`` of a cached cross K/V: a view when emulated;
    a group's block, or its width blocks gathered (serving only)."""
    if sh.emulated:
        return t[:, :, kv[0]:kv[1]] if kv_split else t
    if t.shape[-1] != hd:
        return torch.cat(sh.mm.all_gather([t.contiguous()]), dim=-1)
    return t


def write_cross_kv(p, memory: torch.Tensor, cache: dict, cfg, sh: Shard) -> None:
    """The cross K/V of ``memory`` into a decoder layer's ``ck`` / ``cv``
    (its layout: kv heads over 'model', or the width), once a prefill."""
    B, Mm, _ = memory.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for m in sh.local:
        _, kv, kv_split, _, _ = _attn_plan(H, KV, hd, sh.M, m, False)
        for name, w in (("ck", p["wk"]), ("cv", p["wv"])):
            t = cache[name]
            new = (memory @ sh.part(w, 1, kv[0] * hd, kv[1] * hd)).reshape(B, Mm, -1, hd)
            if sh.emulated:
                (t[:, :, kv[0]:kv[1]] if kv_split else t).copy_(new)
            elif t.shape[-1] != hd:
                wl = t.shape[-1]
                t.copy_(new[..., m * wl:(m + 1) * wl])
            else:
                t.copy_(new)


# ---------------------------------------------------------------------------
# MLPs, experts, the RG-LRU, the xLSTM blocks
# ---------------------------------------------------------------------------


def swiglu(p, x: torch.Tensor, sh: Shard) -> list[torch.Tensor]:
    ff = sh.shape(p["w_gate"])[1]
    parts = []
    for m, x in zip(sh.local, sh.fan(x)):
        (lo, hi), counts = sh.split(ff, m)
        if sh.skip(counts):
            parts.append(None)
            continue
        h = F.silu(x @ sh.part(p["w_gate"], 1, lo, hi)) * (x @ sh.part(p["w_up"], 1, lo, hi))
        parts.append(sh.counted(h @ sh.part(p["w_down"], 0, lo, hi), counts))
    return parts


def gelu_mlp(p, x: torch.Tensor, sh: Shard) -> list[torch.Tensor]:
    ff = sh.shape(p["w_in"])[1]
    parts = []
    for m, x in zip(sh.local, sh.fan(x)):
        (lo, hi), counts = sh.split(ff, m)
        if sh.skip(counts):
            parts.append(None)
            continue
        h = F.gelu(x @ sh.part(p["w_in"], 1, lo, hi), approximate="tanh")
        parts.append(sh.counted(h @ sh.part(p["w_out"], 0, lo, hi), counts))
    return parts


def moe(p, x: torch.Tensor, cfg, sh: Shard) -> list[torch.Tensor]:
    """Expert parallelism: shard m runs experts [m·E/M, (m+1)·E/M) on the
    dispatch rows routed to them (the global routing of
    :func:`~.moe.route`); the shared expert is an MLP over the axis."""
    B, S, d = x.shape
    T, k = B * S, cfg.n_experts_per_token
    E = sh.shape(p["router"])[1]
    parts, x_in = [], x
    for m, x in zip(sh.local, sh.fan(x_in)):
        xt = x.reshape(T, d)
        (elo, ehi), counts = sh.split(E, m)
        if sh.skip(counts):
            parts.append(None)
            continue
        gates, eidx, slot, keep, cap = moe_route(p, xt, cfg, sh.data_route,
                                                 router=sh.whole(p["router"]))
        El = ehi - elo
        mine = keep & (eidx >= elo) & (eidx < ehi)
        lslot = torch.where(mine, slot - elo * cap, El * cap)
        buf = torch.zeros((El * cap + 1, d), dtype=x.dtype, device=x.device)
        buf.index_add_(0, lslot.reshape(-1), torch.repeat_interleave(xt, k, dim=0)
                       * mine.reshape(T * k, 1).to(x.dtype))
        eb = buf[:El * cap].reshape(El, cap, d)
        h = F.silu(torch.einsum("ecd,edf->ecf", eb, sh.part(p["w_gate"], 0, elo, ehi))) \
            * torch.einsum("ecd,edf->ecf", eb, sh.part(p["w_up"], 0, elo, ehi))
        eo = torch.einsum("ecf,efd->ecd", h, sh.part(p["w_down"], 0, elo, ehi))
        eo = torch.cat([eo.reshape(El * cap, d), torch.zeros((1, d), dtype=eo.dtype,
                                                             device=eo.device)])
        out = torch.sum(eo[lslot] * (gates * mine).to(eo.dtype)[..., None], dim=1)
        parts.append(sh.counted(out.reshape(B, S, d), counts))
    if "shared" in p:
        parts = [a if b is None else b if a is None else a + b
                 for a, b in zip(parts, swiglu(p["shared"], x_in, sh))]
    return parts


def _state_io(sh: Shard, t: torch.Tensor, lo: int, hi: int, full: int):
    """(read, write target) of channels [lo, hi) of a recurrent state
    whose last dimension is ``full`` channels whole: emulated a view; in
    a group the local block (split on the width over 'model') or the
    whole state."""
    if sh.emulated or t.shape[-1] == hi - lo:
        view = t[..., lo:hi] if sh.emulated else t
        return view, view
    if t.shape[-1] == full:
        return t[..., lo:hi], t[..., lo:hi]
    # a width-split state read by a shard that works on every channel
    whole = torch.cat(sh.mm.all_gather([t.contiguous()]), dim=-1)
    m, w = sh.mrank, t.shape[-1]
    return whole[..., lo:hi], (t, (m * w - lo, (m + 1) * w - lo))


def _write_state(target, value: torch.Tensor) -> None:
    if isinstance(target, tuple):
        t, (a, b) = target
        t.copy_(value[..., a:b])
    else:
        target.copy_(value)


def rglru(p, x: torch.Tensor, cfg, sh: Shard, state: dict | None = None) -> list[torch.Tensor]:
    """The RG-LRU block split on its width: shard m runs the block-diagonal
    heads [m·nb/M, (m+1)·nb/M) of the gates, their channels of the x / y
    branches, the conv and Λ, the scan on them, and contracts its rows of
    ``w_out``; the state's h / conv are split on the width."""
    rw = sh.shape(p["w_x"])[1]
    nb = sh.shape(p["w_a"])[0]
    bs = rw // nb
    parts = []
    for m, x in zip(sh.local, sh.fan(x)):
        (blo, bhi), counts = sh.split(nb, m)
        if sh.skip(counts):
            parts.append(None)
            continue
        lo, hi = blo * bs, bhi * bs
        y = F.gelu(x @ sh.part(p["w_y"], 1, lo, hi), approximate="tanh")
        u = x @ sh.part(p["w_x"], 1, lo, hi)
        h_io = conv_io = None
        if state is not None:
            h_io = _state_io(sh, state["h"], lo, hi, rw)
            conv_io = _state_io(sh, state["conv"], lo, hi, rw)
        u, new_tail = _causal_conv1d(u, sh.part(p["conv_w"], 1, lo, hi),
                                     None if conv_io is None else conv_io[0])
        r = _block_diag_apply(u, sh.part(p["w_a"], 0, blo, bhi))
        i = _block_diag_apply(u, sh.part(p["w_i"], 0, blo, bhi))
        h = _rglru_scan(u, r, i, sh.part(p["lam"], 0, lo, hi),
                        None if h_io is None else h_io[0])
        out = (y.float() * h).to(x.dtype) @ sh.part(p["w_out"], 0, lo, hi)
        if state is not None:  # the old tail is read: write the new state over it
            _write_state(h_io[1], h[:, -1, :])
            _write_state(conv_io[1], new_tail)
        parts.append(sh.counted(out, counts))
    return parts


def whole_block(fn, p, x: torch.Tensor, cfg, sh: Shard, state: dict | None = None
                ) -> list[torch.Tensor]:
    """A block run whole on every shard, its leaves gathered over 'model'
    (the xLSTM blocks: the mLSTM's [z | gate] columns and readout, the
    sLSTM's layer-split input gate); only shard 0's output counts.  Its
    state is whole on every shard (``cache_pspecs`` splits only its
    batch), so every shard writes the same values."""
    parts = []
    for m, x in zip(sh.local, sh.fan(x)):
        if sh.skip(m == 0):
            parts.append(None)
            continue
        pw = {name: sh.whole(t) for name, t in p.named_parameters()}
        out, _ = fn(pw, x, cfg, state=state)
        parts.append(sh.counted(out, m == 0))
    return parts


# ---------------------------------------------------------------------------
# the vocabulary: embedding, logits, loss
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor, cfg, sh: Shard) -> list[torch.Tensor]:
    """:func:`~.layers.embed_lookup` over the vocabulary split: each shard
    reads the ids in its rows (``jnp.take``'s wrap of [−Vp, 0) included),
    the rows are summed over 'model', and shard 0 writes the NaN row of
    an id outside [−Vp, Vp).  Returns the residual's blocks."""
    Vp = sh.shape(table)[0]
    tokens = tokens.to(table.device)
    inside = (tokens >= -Vp) & (tokens < Vp)
    idx = torch.where(tokens < 0, tokens + Vp, tokens)
    parts = []
    for m in sh.local:
        (lo, hi), counts = sh.split(Vp, m)
        if sh.skip(counts):
            parts.append(None)
            continue
        t = sh.part(table, 0, lo, hi)
        mine = inside & (idx >= lo) & (idx < hi)
        rows = t[(idx - lo).clamp(0, hi - lo - 1)].masked_fill(~mine[..., None], 0)
        if m == 0:
            rows = rows.masked_fill(~inside[..., None], float("nan"))
        parts.append(sh.counted(rows.to(cfg.dtype), counts))
    return sh.exit(parts)


def _head_parts(sh: Shard, x: torch.Tensor, head: torch.Tensor, tied: bool):
    """[(lo, hi, counts, float32 logits of vocabulary rows [lo, hi))] a
    local shard, of the (·, d) input x (``None`` for a shard that did not
    run); ``tied``: ``head`` is the embedding."""
    Vp = sh.shape(head)[0 if tied else 1]
    out = []
    for m, x in zip(sh.local, sh.fan(x)):
        (lo, hi), counts = sh.split(Vp, m)
        if sh.skip(counts):
            out.append(None)
            continue
        w = sh.part(head, 0, lo, hi).T if tied else sh.part(head, 1, lo, hi)
        out.append((lo, hi, counts, (x @ w).float()))
    return out


def vocab_logits(sh: Shard, x: torch.Tensor, head: torch.Tensor, tied: bool) -> torch.Tensor:
    """The float32 logits (·, Vp), whole on every shard (gathered over
    'model'; where the axis does not divide Vp every shard has them)."""
    parts = _head_parts(sh, x, head, tied)
    if sh.shape(head)[0 if tied else 1] % sh.M:
        return parts[0][3]
    return sh.gather([lg for _, _, _, lg in parts], dim=-1)


def _slab_loss(sh: Shard, tied: bool, xc: torch.Tensor, head: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    """Σ over the slab's tokens of lse − the gold logit, the logits split
    over 'model': the max over the axis (no gradient), the exponentials'
    sum and the gold logit (``jax.nn.one_hot``'s rule: a label outside
    [0, Vp) has no gold logit) summed over it."""
    parts = [p for p in _head_parts(sh, xc, head, tied) if p is not None]
    mx = sh.pmax([lg.detach().amax(dim=-1) for _, _, _, lg in parts])
    sums, golds = [], []
    for lo, hi, counts, lg in parts:
        vocab = torch.arange(lo, hi, device=lg.device)
        onehot = (lc.long()[..., None] == vocab).to(lg.dtype)
        sums.append(sh.counted(torch.sum(torch.exp(lg - mx[..., None]), dim=-1), counts))
        golds.append(sh.counted(torch.sum(lg * onehot, dim=-1), counts))
    lse = mx + torch.log(sh.psum(sums))
    return torch.sum(lse - sh.psum(golds))


def chunked_cross_entropy(sh: Shard, x: torch.Tensor, head: torch.Tensor, tied: bool,
                          labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """:func:`~.transformer.chunked_cross_entropy` over the vocabulary
    split; x is the whole final-normed hidden state."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    fn = functools.partial(_slab_loss, sh, tied)
    for c in range(S // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        total = total + L.remat_call(fn, x[:, rows], head, labels[:, rows])
    return total / (B * S)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def _block(kind: str, p, xs, cfg, sh: Shard, *, positions, cache, cache_index, memory,
           lsh_shard):
    eps = cfg.norm_eps
    if kind == "rec":
        xs = _add(xs, sh.exit(rglru(p["rec"], sh.enter(_norm(sh, xs, p["ln1"], eps)), cfg, sh,
                                    state=cache)))
        return _add(xs, sh.exit(swiglu(p["mlp"], sh.enter(_norm(sh, xs, p["ln2"], eps)), sh)))
    if kind in ("mlstm", "slstm"):
        fn = mlstm_block_apply if kind == "mlstm" else slstm_block_apply
        return _add(xs, sh.exit(whole_block(fn, p[kind], sh.enter(_norm(sh, xs, p["ln1"], eps)),
                                            cfg, sh, state=cache)))
    use_lsh = cfg.lsh_attention and kind != "local"
    xs = _add(xs, sh.exit(attention(
        p["attn"], sh.enter(_norm(sh, xs, p["ln1"], eps)), cfg, sh, positions=positions,
        cache=cache, cache_index=cache_index, window=cfg.window if kind == "local" else 0,
        use_lsh=use_lsh, lsh_shard=lsh_shard)))
    if kind == "cross":
        xs = _add(xs, sh.exit(cross_attention(p["xattn"], sh.enter(_norm(sh, xs, p["lnx"], eps)),
                                              memory, cfg, sh)))
    h = sh.enter(_norm(sh, xs, p["ln2"], eps))
    return _add(xs, sh.exit(moe(p["moe"], h, cfg, sh) if kind == "moe"
                            else swiglu(p["mlp"], h, sh)))


def forward(params, tokens: torch.Tensor, cfg, sh: Shard, *, caches: list[dict] | None = None,
            position0=0, memory: torch.Tensor | None = None, remat: str = "unit",
            logits_slice: str = "all", lsh_shard: tuple | None = None):
    """:func:`~.transformer.forward` over the model axis.  Returns
    (float32 logits (B, S or 1, Vp), whole on every shard, or for
    ``"hidden"`` the final-normed residual's blocks; the caches, written
    in place)."""
    from .transformer import layer_kinds, layer_plan

    if logits_slice not in ("all", "last", "hidden"):
        raise ValueError(f"logits_slice={logits_slice!r}")
    kinds = layer_kinds(cfg)
    unit, n_units, _ = layer_plan(cfg)
    S = tokens.shape[1]
    xs = embed(params.embed, tokens, cfg, sh)
    positions = position0 + torch.arange(S, device=xs[0].device)

    def run(xs, lo: int, hi: int):
        for i in range(lo, hi):
            xs = _block(kinds[i], params.blocks[i], xs, cfg, sh, positions=positions,
                        cache=None if caches is None else caches[i], cache_index=position0,
                        memory=memory, lsh_shard=lsh_shard)
        return xs

    unit_remat = remat if caches is None else "none"
    for u in range(n_units):
        xs = L.remat_call(run, xs, u * len(unit), (u + 1) * len(unit), remat=unit_remat)
    xs = run(xs, n_units * len(unit), len(kinds))
    xs = _norm(sh, xs, params.final_norm, cfg.norm_eps)
    if logits_slice == "hidden":
        return xs, caches
    x = sh.enter(xs)
    if logits_slice == "last":
        x = x[:, -1:, :]
    tied = params.lm_head is None
    return vocab_logits(sh, x, params.embed if tied else params.lm_head, tied), caches


def loss_fn(params, batch: dict, cfg, sh: Shard, *, remat: str = "unit", ce_chunk: int = 512):
    """:func:`~.transformer.loss_fn` over the model axis."""
    xs, _ = forward(params, batch["tokens"], cfg, sh, memory=batch.get("image_embeds"),
                    remat=remat, logits_slice="hidden")
    tied = params.lm_head is None
    return chunked_cross_entropy(sh, sh.enter(xs), params.embed if tied else params.lm_head,
                                 tied, batch["labels"], ce_chunk)


# ---------------------------------------------------------------------------
# the encoder-decoder (no SP: the reference applies it to the decoder LMs only)
# ---------------------------------------------------------------------------


def _encode(params, frames: torch.Tensor, cfg, sh: Shard) -> torch.Tensor:
    M = frames.shape[1]
    positions = torch.arange(M, device=frames.device)
    xs, eps = [frames.to(cfg.dtype)], cfg.norm_eps
    for p in params.encoder:
        xs = _add(xs, sh.exit(attention(p["attn"], sh.enter(_norm(sh, xs, p["ln1"], eps)), cfg,
                                        sh, positions=positions, causal=False)))
        xs = _add(xs, sh.exit(gelu_mlp(p["mlp"], sh.enter(_norm(sh, xs, p["ln2"], eps)), sh)))
    return _norm(sh, xs, params.enc_norm, eps)[0]


def _dec_layer(p, xs, cfg, sh: Shard, *, positions, cache, cache_index, memory, cross_kv=None):
    eps = cfg.norm_eps
    xs = _add(xs, sh.exit(attention(p["attn"], sh.enter(_norm(sh, xs, p["ln1"], eps)), cfg, sh,
                                    positions=positions, cache=cache, cache_index=cache_index)))
    xs = _add(xs, sh.exit(cross_attention(p["xattn"], sh.enter(_norm(sh, xs, p["lnx"], eps)),
                                          memory, cfg, sh, cross_kv=cross_kv)))
    return _add(xs, sh.exit(gelu_mlp(p["mlp"], sh.enter(_norm(sh, xs, p["ln2"], eps)), sh)))


def whisper_forward(params, tokens: torch.Tensor, frames: torch.Tensor, cfg, sh: Shard, *,
                    caches: dict | None = None, position0=0, logits_slice: str = "all"):
    """:func:`~.whisper.forward` over the model axis."""
    if sh.sp:
        raise ValueError("the encoder-decoder runs without sequence parallelism, as the "
                         "reference's")
    memory = _encode(params, frames, cfg, sh)
    S = tokens.shape[1]
    xs = embed(params.embed, tokens, cfg, sh)
    positions = position0 + torch.arange(S, device=xs[0].device)
    for i, p in enumerate(params.decoder):
        if caches is None:
            xs = L.remat_call(functools.partial(_dec_layer, p, cfg=cfg, sh=sh,
                                                positions=positions, cache=None,
                                                cache_index=position0, memory=memory), xs)
        else:
            xs = _dec_layer(p, xs, cfg, sh, positions=positions, cache=caches["self"][i],
                            cache_index=position0, memory=memory)
    if caches is not None:
        for p, c in zip(params.decoder, caches["cross"]):
            write_cross_kv(p["xattn"], memory, c, cfg, sh)
    return _whisper_head(params, xs, cfg, sh, logits_slice), caches


def _whisper_head(params, xs, cfg, sh: Shard, logits_slice: str) -> torch.Tensor:
    x = sh.enter(_norm(sh, xs, params.final_norm, cfg.norm_eps))
    if logits_slice == "last":
        x = x[:, -1:, :]
    return vocab_logits(sh, x, params.lm_head, False)


def whisper_decode_step(params, caches: dict, batch: dict, cfg, sh: Shard):
    """:func:`~.whisper.decode_step` over the model axis."""
    tokens, position0 = batch["tokens"], batch["position"]
    S = tokens.shape[1]
    xs = embed(params.embed, tokens, cfg, sh)
    positions = position0 + torch.arange(S, device=xs[0].device)
    for p, c_self, c_cross in zip(params.decoder, caches["self"], caches["cross"]):
        xs = _dec_layer(p, xs, cfg, sh, positions=positions, cache=c_self,
                        cache_index=position0, memory=None, cross_kv=c_cross)
    return _whisper_head(params, xs, cfg, sh, "last"), caches


def whisper_loss_fn(params, batch: dict, cfg, sh: Shard, **_):
    """:func:`~.whisper.loss_fn` over the model axis: the CE over the
    full logits, split over the vocabulary."""
    memory = _encode(params, batch["audio_frames"], cfg, sh)
    tokens = batch["tokens"]
    xs = embed(params.embed, tokens, cfg, sh)
    positions = torch.arange(tokens.shape[1], device=xs[0].device)
    for p in params.decoder:
        xs = L.remat_call(functools.partial(_dec_layer, p, cfg=cfg, sh=sh, positions=positions,
                                            cache=None, cache_index=0, memory=memory), xs)
    x = sh.enter(_norm(sh, xs, params.final_norm, cfg.norm_eps))
    return chunked_cross_entropy(sh, x, params.lm_head, False, batch["labels"], x.shape[1])
