"""Foundational transformer layers, the port of ``repro.models.layers``.

Parameters live in small ``nn.Module``s whose tensors are addressed by
name, ``p["wq"]``, as the reference's dicts are, so every ``*_apply``
takes either such a module or a plain dict of tensors.  ``init_*``
draws from an explicit ``torch.Generator`` (the reference draws from a
``jax.random`` key; the two give different numbers, so tests carry the
reference's parameters across with ``convert.lm_params_from_numpy``).

Attention is CHUNKED (online softmax over KV blocks of 1024 rows, the
flash recurrence in plain PyTorch) so the (Sq × Sk) score matrix never
materializes; its masks use −1e30, never −inf, as the reference's do,
and the numbers the tests hold depend on that.  Nothing here is a
Pallas kernel in the reference, so nothing here is a hand-written one:
the products stay ``torch.matmul`` / ``einsum``.

A KV cache is written IN PLACE (the counterpart of the reference's
donated decode buffers), with the reference's clamped write offset.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# ---------------------------------------------------------------------------
# parameter containers and draws
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """A module whose tensors are addressed by name, ``p["wq"]``, like the
    reference's parameter dicts.  Tensors are created frozen, as serving
    wants them; ``requires_grad_()`` (``nn.Module``'s switch, on a block
    or a whole model) makes them trainable, as ``train.train_step``
    does."""

    def __init__(self, **tensors):
        super().__init__()
        for name, value in tensors.items():
            self[name] = value

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __setitem__(self, name: str, value) -> None:
        if isinstance(value, nn.Module):
            setattr(self, name, value)
        else:
            setattr(self, name, nn.Parameter(value, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


REMAT_MODES = ("unit", "dots", "none")

# matmuls without batch dimensions (x @ W): what the reference's
# dots_with_no_batch_dims_saveable policy keeps; the attention and
# expert einsums run as bmm and are recomputed, as there
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, *args, remat: str = "unit"):
    """``fn(*args)``, its activations recomputed in the backward as the
    reference's ``jax.checkpoint`` recomputes them: ``"unit"`` saves
    nothing (``nothing_saveable``), ``"dots"`` keeps the outputs of the
    matmuls without batch dimensions, ``"none"`` calls ``fn`` plainly.
    Where no gradient is recorded every mode calls ``fn`` plainly."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def normal(gen: torch.Generator | None, shape, device: torch.device) -> torch.Tensor:
    """float32 standard normals from ``gen`` on ``device``; on the meta
    device only the shape (``abstract_params``)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, scale: float = 1.0, *,
               device: torch.device) -> torch.Tensor:
    std = scale * (d_in**-0.5)
    return (normal(gen, (d_in, d_out), device) * std).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` in its default fill mode: a
    token t in [−Vp, Vp) reads row t mod Vp (−1 reads the last row), any
    other token a NaN row.  The index is clamped and the row masked on
    the device: no host read, no device-side assert."""
    Vp = table.shape[0]
    tokens = tokens.to(table.device)  # host tokens index a card's table, as indexing does
    inside = (tokens >= -Vp) & (tokens < Vp)
    idx = torch.where(tokens < 0, tokens + Vp, tokens).clamp(0, Vp - 1)
    return table[idx].masked_fill(~inside[..., None], float("nan"))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * weight.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE.  x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------


def weak_scale(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 rounded to ``dtype``: JAX multiplies an array by a Python
    float in the array's own type (weak typing), torch by the float."""
    return float(torch.tensor(hd**-0.5, dtype=dtype))


def _online_softmax(q, k, v, *, causal, q_offset, window, kv_len, chunk,
                    k_offset=0, k_end=None):
    """The flash recurrence of :func:`chunked_attention` over the keys
    ``k`` / ``v`` at global positions ``k_offset + j``: its unnormalised
    (B, Sq, KV, G, hd) output, running max and sum (B, Sq, KV, G), all
    float32.  Rows at or past ``k_end`` (a block's end) are masked too."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    dev = q.device
    qr = (q * weak_scale(hd, q.dtype)).reshape(B, Sq, KV, G, hd).float()
    qpos = q_offset + torch.arange(Sq, device=dev)  # (Sq,)

    chunk = min(chunk, Sk)
    nk = -(-Sk // chunk)
    pad = nk * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KV, G), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    limit = Sk if kv_len is None else kv_len
    for ci in range(nk):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()  # (B, ck, KV, hd)
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        kpos = k_offset + ci * chunk + torch.arange(chunk, device=dev)  # (ck,)
        s = torch.einsum("bqkgd,bckd->bqkgc", qr, kb)  # (B, Sq, KV, G, ck)
        mask = kpos[None, :] < limit  # (1, ck) valid rows
        if k_end is not None:
            mask = mask & (kpos[None, :] < k_end)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        # in place only where no gradient is recorded (amax saves s for
        # its backward); the same arithmetic out of place where one is
        fill = ~mask[None, :, None, None, :]
        s = s.masked_fill(fill, -1e30) if s.requires_grad else s.masked_fill_(fill, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        if s.requires_grad:
            p = torch.exp(s - m_new[..., None])
        else:
            p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    return acc, m, l


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    window: int = 0,
    kv_len: torch.Tensor | int | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; O(Sq·chunk) live memory.

    q_offset: global position of q[0] (for decode with a cache).
    window:   sliding-window size (0 = unlimited) — local attention.
    kv_len:   #valid cache rows (decode masks the not-yet-written tail).
    ``q_offset`` and ``kv_len`` may be 0-d tensors: nothing here reads
    them on the host.
    """
    B, Sq, H, hd = q.shape
    acc, _, l = _online_softmax(q, k, v, causal=causal, q_offset=q_offset, window=window,
                                kv_len=kv_len, chunk=chunk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def split_cache_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, Smax, KV, hd) emulated, a rank's (B, Smax/P, KV, hd) block in a group
    v: torch.Tensor,
    *,
    mesh,
    axis,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    window: int = 0,
    kv_len: torch.Tensor | int,
    chunk: int = 1024,
) -> torch.Tensor:
    """:func:`chunked_attention` of the S queries over a cache whose
    sequence is split over ``mesh``'s ``axis`` (a name or ('data',
    'model'), data-major), without any shard holding the whole cache.

    Each shard runs the flash recurrence over its own rows at their
    global positions (causal, window and ``kv_len`` masks on them) and
    keeps its unnormalised output, running max and sum; only those
    partials, (B, S, H, hd + 2) float32 a shard, cross the wire, gathered
    in shard order and merged by an ordered log-sum-exp, so the emulated
    form and a group of any backend give the same bits.  A shard with no
    valid row keeps a max of −1e30, which the merge weighs to zero beside
    the shard that holds the query's own row."""
    from .lsh_attention import _shard_blocks, seq_shards

    B, S, H, hd = q.shape
    am = mesh.axis(axis)
    Pn = seq_shards(mesh, axis)
    if am.size != Pn:
        raise ValueError(f"sequence axes of {Pn} shards on an axis of {am.size}")
    if am.emulated and k.shape[1] % Pn:
        raise ValueError(f"a cache of {k.shape[1]} rows does not split over {Pn} shards")
    parts = []
    for (p, kb), (_, vb) in zip(_shard_blocks(am, k), _shard_blocks(am, v)):
        Sl = kb.shape[1]
        acc, m, l = _online_softmax(q, kb, vb, causal=causal, q_offset=q_offset,
                                    window=window, kv_len=kv_len, chunk=chunk,
                                    k_offset=p * Sl, k_end=(p + 1) * Sl)
        parts.append(torch.cat([acc.reshape(B, S, H, hd), m.reshape(B, S, H, 1),
                                l.reshape(B, S, H, 1)], dim=-1))
    every = am.all_gather(parts)
    m = every[0][..., hd]
    for t in every[1:]:
        m = torch.maximum(m, t[..., hd])
    acc = l = 0
    for t in every:
        w = torch.exp(t[..., hd] - m)
        acc = acc + t[..., :hd] * w[..., None]
        l = l + t[..., hd + 1] * w
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention block
# ---------------------------------------------------------------------------


#: where ``lsh_generator``'s seeds start: far from any seed a caller passes
LSH_SEED_OFFSET = 1 << 40


def lsh_generator(seed: int, device: torch.device) -> torch.Generator | None:
    """The stream the PM-LSH projections ``lsh_a`` are drawn from, apart
    from the weights' (the reference folds 7 into each layer's key), so
    that one seed draws the same weights with PM-LSH attention on and
    off; ``None`` on the meta device."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed + LSH_SEED_OFFSET)


def init_attention(gen, cfg, dtype=None, *, device: torch.device,
                   lsh_gen: torch.Generator | None) -> Params:
    dtype = dtype or cfg.dtype
    d, hd = cfg.d_model, cfg.head_dim
    p = Params(
        wq=dense_init(gen, d, cfg.n_heads * hd, dtype, device=device),
        wk=dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device),
        wv=dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device),
        wo=dense_init(gen, cfg.n_heads * hd, d, dtype, device=device),
    )
    if cfg.lsh_attention:
        # PM-LSH projection matrix for retrieval attention (fixed, not
        # trained — the paper's 2-stable family; one per layer)
        p["lsh_a"] = normal(lsh_gen, (hd, cfg.lsh_m), device).to(dtype)
    return p


def write_rows(buf: torch.Tensor, new: torch.Tensor, index, *, base: int = 0,
               total: int | None = None) -> None:
    """``buf[:, index:index + S] = new`` in place, at the start
    ``lax.dynamic_update_slice`` takes: a negative index counts from the
    end (+ Smax), then the start is clamped to [0, Smax − S].  A tensor
    ``index`` stays on the device (no host read).

    ``buf`` may be one block of a cache of ``total`` rows split along
    dim 1, holding rows [base, base + buf.shape[1]): the start is taken
    over the whole cache and only the rows that fall in the block are
    written (a tensor index with one row: the block's row rewritten with
    its own value when another block owns the position)."""
    S, Sl = new.shape[1], buf.shape[1]
    Smax = Sl if total is None else total
    if S > Smax:
        raise ValueError(f"writing {S} rows into a cache of {Smax}")
    if isinstance(index, torch.Tensor):
        start = torch.clamp(torch.where(index < 0, index + Smax, index), 0, Smax - S)
        if total is None:
            buf.index_copy_(1, start + torch.arange(S, device=buf.device), new)
        elif S == 1:  # the row's place in this block, clamped; rewritten as is if not ours
            j = torch.clamp(start - base, 0, Sl - 1).reshape(1)
            mine = (start >= base) & (start < base + Sl)
            buf.index_copy_(1, j, torch.where(mine, new, buf.index_select(1, j)))
        else:  # block row j takes new row base + j − start where that row exists
            rows = base - start + torch.arange(Sl, device=buf.device)
            mine = ((rows >= 0) & (rows < S)).reshape((1, Sl) + (1,) * (buf.ndim - 2))
            buf.copy_(torch.where(mine, new.index_select(1, rows.clamp(0, S - 1)), buf))
        return
    index = int(index)
    start = min(max(index + Smax if index < 0 else index, 0), Smax - S)
    lo, hi = max(start, base), min(start + S, base + Sl)
    if lo < hi:
        buf[:, lo - base:hi - base] = new[:, lo - start:hi - start]


def from_zero(cache_index) -> bool:
    """Whether a block is written at position 0 (a prefill): an int 0; a
    tensor index is read on the device only, so it never counts."""
    return not isinstance(cache_index, torch.Tensor) and cache_index == 0


def attention_apply(
    p,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    *,
    positions: torch.Tensor,  # (S,) global positions of x
    cache: dict | None = None,  # {"k","v"[,"pk"]}: (B, Smax, KV, ·)
    cache_index: torch.Tensor | int = 0,  # write offset into the cache
    window: int = 0,
    use_lsh: bool = False,
    causal: bool = True,
    lsh_shard: tuple | None = None,  # (mesh, axis) when the cache's sequence is split
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with optional KV cache and PM-LSH retrieval path.

    Returns (out, cache): the cache's buffers are written in place and
    the same dict comes back.

    With ``lsh_shard`` the cache's sequence is split over the mesh's
    data axis, or over ('data', 'model') (whole tensors read as P blocks
    when emulated, the rank's own block in a group): each row goes to the
    block that owns its position; a PM-LSH layer's one-token step runs
    :func:`~.lsh_attention.lsh_decode_attention_sharded`; a prefill from
    position 0 attends over its own keys; any other call (several tokens
    past position 0, a layer that is not PM-LSH) runs
    :func:`split_cache_attention`, so no shard needs the whole cache.
    Without a cache ``lsh_shard`` does nothing, as in the reference.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        lsh_shard = None

    if cache is not None:
        block = {}
        if lsh_shard is not None and not lsh_shard[0].emulated:
            am, Sl = lsh_shard[0].axis(lsh_shard[1]), cache["k"].shape[1]
            block = {"base": am.rank * Sl, "total": am.size * Sl}
        write_rows(cache["k"], k, cache_index, **block)
        write_rows(cache["v"], v, cache_index, **block)
        if "pk" in cache:  # PM-LSH projected keys ride along in the cache
            pk_new = torch.einsum("bskd,dm->bskm", k.float(), p["lsh_a"].float())
            write_rows(cache["pk"], pk_new.to(k.dtype), cache_index, **block)
        k_all, v_all = cache["k"], cache["v"]
        kv_len = cache_index + S
    else:
        k_all, v_all = k, v
        kv_len = None

    if use_lsh and cache is not None and S == 1:
        from .lsh_attention import lsh_decode_attention, lsh_decode_attention_sharded

        if lsh_shard is not None:
            out = lsh_decode_attention_sharded(
                q, cache["k"], cache["v"], cache["pk"], p["lsh_a"], kv_len=kv_len,
                topk=cfg.lsh_topk, mesh=lsh_shard[0], axis=lsh_shard[1])
        else:
            out = lsh_decode_attention(q, cache["k"], cache["v"], cache["pk"], p["lsh_a"],
                                       kv_len=kv_len, topk=cfg.lsh_topk)
    elif lsh_shard is not None and from_zero(cache_index):
        out = chunked_attention(q, k, v, causal=causal, q_offset=positions[0], window=window)
    elif lsh_shard is not None:
        out = split_cache_attention(q, k_all, v_all, mesh=lsh_shard[0], axis=lsh_shard[1],
                                    causal=causal, q_offset=positions[0], window=window,
                                    kv_len=kv_len)
    elif cache is None and k_all.shape[1] % min(1024, k_all.shape[1]) == 0:
        # the TRAIN route: flash attention with the reference's custom VJP
        from .flash_attention import flash_attention

        out = flash_attention(q, k_all, v_all, causal, window)
    else:
        out = chunked_attention(
            q, k_all, v_all,
            causal=causal,
            q_offset=positions[0],
            window=window,
            kv_len=kv_len,
        )
    return out.reshape(B, S, H * hd) @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross-attention block (VLM image layers / whisper decoder)
# ---------------------------------------------------------------------------


def init_cross_attention(gen, cfg, dtype=None, *, device: torch.device) -> Params:
    dtype = dtype or cfg.dtype
    d, hd = cfg.d_model, cfg.head_dim
    return Params(
        wq=dense_init(gen, d, cfg.n_heads * hd, dtype, device=device),
        wk=dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device),
        wv=dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=device),
        wo=dense_init(gen, cfg.n_heads * hd, d, dtype, device=device),
    )


def cross_attention_apply(p, x: torch.Tensor, memory: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) queries; memory: (B, M, d) precomputed modality tokens."""
    B, S, _ = x.shape
    M = memory.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (memory @ p["wk"]).reshape(B, M, KV, hd)
    v = (memory @ p["wv"]).reshape(B, M, KV, hd)
    out = chunked_attention(q, k, v, causal=False)
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(gen, d: int, ff: int, dtype, *, device: torch.device) -> Params:
    return Params(w_gate=dense_init(gen, d, ff, dtype, device=device),
                  w_up=dense_init(gen, d, ff, dtype, device=device),
                  w_down=dense_init(gen, ff, d, dtype, device=device))


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def init_gelu_mlp(gen, d: int, ff: int, dtype, *, device: torch.device) -> Params:
    return Params(w_in=dense_init(gen, d, ff, dtype, device=device),
                  w_out=dense_init(gen, ff, d, dtype, device=device))


def gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; torch's is erf
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
