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

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# parameter containers and draws
# ---------------------------------------------------------------------------


class Params(nn.Module):
    """A module whose tensors are addressed by name, ``p["wq"]``, like the
    reference's parameter dicts.  Tensors are frozen: the port serves,
    and training (with gradients) comes later."""

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
        kpos = ci * chunk + torch.arange(chunk, device=dev)  # (ck,)
        s = torch.einsum("bqkgd,bckd->bqkgc", qr, kb)  # (B, Sq, KV, G, ck)
        mask = kpos[None, :] < limit  # (1, ck) valid rows
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s.masked_fill_(~mask[None, :, None, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention block
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, dtype=None, *, device: torch.device) -> Params:
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
        p["lsh_a"] = normal(gen, (hd, cfg.lsh_m), device).to(dtype)
    return p


def write_rows(buf: torch.Tensor, new: torch.Tensor, index) -> None:
    """``buf[:, index:index + S] = new`` in place, at the start
    ``lax.dynamic_update_slice`` takes: a negative index counts from the
    end (+ Smax), then the start is clamped to [0, Smax − S].  A tensor
    ``index`` stays on the device (no host read)."""
    S, Smax = new.shape[1], buf.shape[1]
    if S > Smax:
        raise ValueError(f"writing {S} rows into a cache of {Smax}")
    if isinstance(index, torch.Tensor):
        start = torch.clamp(torch.where(index < 0, index + Smax, index), 0, Smax - S)
        buf.index_copy_(1, start + torch.arange(S, device=buf.device), new)
    else:
        index = int(index)
        start = min(max(index + Smax if index < 0 else index, 0), Smax - S)
        buf[:, start:start + S] = new


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
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with optional KV cache and PM-LSH retrieval path.

    Returns (out, cache): the cache's buffers are written in place and
    the same dict comes back.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        write_rows(cache["k"], k, cache_index)
        write_rows(cache["v"], v, cache_index)
        if "pk" in cache:  # PM-LSH projected keys ride along in the cache
            pk_new = torch.einsum("bskd,dm->bskm", k.float(), p["lsh_a"].float())
            write_rows(cache["pk"], pk_new.to(k.dtype), cache_index)
        k_all, v_all = cache["k"], cache["v"]
        kv_len = cache_index + S
    else:
        k_all, v_all = k, v
        kv_len = None

    if use_lsh and cache is not None and S == 1:
        from .lsh_attention import lsh_decode_attention

        out = lsh_decode_attention(q, cache["k"], cache["v"], cache["pk"], p["lsh_a"],
                                   kv_len=kv_len, topk=cfg.lsh_topk)
    elif cache is None and k_all.shape[1] % min(1024, k_all.shape[1]) == 0:
        # the reference's TRAIN route (its flash custom VJP); forward only here
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
