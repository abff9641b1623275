"""Flash attention (plain PyTorch, chunked online softmax), the port of
``repro.models.flash_attention``: ``_forward``, and the custom VJP's
``_fwd`` / ``_bwd`` as a ``torch.autograd.Function``.

The backward keeps only the softmax statistics (out, m, l) of the
forward and RECOMPUTES each chunk's probabilities p = exp(s − lse) from
q and k while it accumulates dq, dk and dv, so its live memory is
O(Sq·chunk) rather than every chunk's p.  It is the training route
``attention_apply`` takes without caches when the key length is a
multiple of the chunk; serving runs the same forward without autograd.
"""
from __future__ import annotations

import torch


def _mask_for(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _chunking(Sk: int, chunk: int) -> tuple[int, int]:
    ck = min(chunk, Sk)
    if Sk % ck:
        raise ValueError(f"Sk={Sk} % chunk={ck}")
    return ck, Sk // ck


def _forward(q, k, v, causal: bool, window: int, chunk: int):
    """Returns (out (B,Sq,KV,G,hd) f32, m, l) — the flash statistics."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    dev = q.device
    scale = hd**-0.5
    qr = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    ck, nk = _chunking(Sk, chunk)
    qpos = torch.arange(Sq, device=dev)

    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KV, G), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    for ci in range(nk):
        kb = k[:, ci * ck:(ci + 1) * ck].float()
        vb = v[:, ci * ck:(ci + 1) * ck].float()
        kpos = ci * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qr, kb)
        mask = _mask_for(qpos, kpos, causal, window)
        s.masked_fill_(~mask[None, :, None, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out, m, l


def _backward(q, k, v, out, m, l, dout, causal: bool, window: int, chunk: int):
    """The reference's ``_bwd``: (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    dev = q.device
    scale = hd**-0.5
    qr = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    do = dout.float().reshape(B, Sq, KV, G, hd)
    # logsumexp per query + delta = Σ dout·out (the flash-bwd invariants)
    lse = m + torch.log(torch.clamp(l, min=1e-30))  # (B,Sq,KV,G)
    delta = torch.sum(do * out, dim=-1)  # (B,Sq,KV,G)
    ck, nk = _chunking(Sk, chunk)
    qpos = torch.arange(Sq, device=dev)

    dq = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=dev)
    dk = torch.empty((B, Sk, KV, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((B, Sk, KV, hd), dtype=v.dtype, device=dev)
    for ci in range(nk):
        rows = slice(ci * ck, (ci + 1) * ck)
        kb = k[:, rows].float()
        vb = v[:, rows].float()
        kpos = ci * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qr, kb)
        mask = _mask_for(qpos, kpos, causal, window)
        s.masked_fill_(~mask[None, :, None, None, :], -1e30)
        p = s.sub_(lse[..., None]).exp_()  # recomputed probabilities
        dv[:, rows] = torch.einsum("bqkgc,bqkgd->bckd", p, do)
        dp = torch.einsum("bqkgd,bckd->bqkgc", do, vb)
        ds = p.mul_(dp.sub_(delta[..., None]))
        dq += torch.einsum("bqkgc,bckd->bqkgd", ds, kb)
        dk[:, rows] = torch.einsum("bqkgc,bqkgd->bckd", ds, qr)
    dq = (dq * scale).reshape(B, Sq, H, hd).to(q.dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's custom VJP: the forward
    saves (q, k, v, out f32 (B,Sq,KV,G,hd), m, l), the backward
    recomputes each chunk's probabilities.  ``causal``, ``window`` and
    ``chunk`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk: int):
        out, m, l = _forward(q, k, v, causal, window, chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, chunk)
        B, Sq, KV, G, hd = out.shape
        return out.reshape(B, Sq, KV * G, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _backward(*ctx.saved_tensors, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) → (B,Sq,H,hd), GQA-aware."""
    return FlashAttention.apply(q, k, v, causal, window, chunk)
