"""Flash attention's forward (plain PyTorch, chunked online softmax), the
port of ``repro.models.flash_attention``'s ``_forward`` and
``flash_attention``.

The reference wraps this forward in a custom VJP whose backward keeps
only the softmax statistics (out, m, l) and recomputes each chunk's
probabilities; it is the route ``forward`` takes without caches when
the key length is a multiple of the chunk.  The port serves, so only
the forward is here: the backward comes with training (ROADMAP A12c)
as a ``torch.autograd.Function``.
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


def _forward(q, k, v, causal: bool, window: int, chunk: int):
    """Returns (out (B,Sq,KV,G,hd) f32, m, l) — the flash statistics."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    dev = q.device
    scale = hd**-0.5
    qr = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    ck = min(chunk, Sk)
    nk = Sk // ck
    if Sk % ck:
        raise ValueError(f"Sk={Sk} % chunk={ck}")
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


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) → (B,Sq,H,hd), GQA-aware."""
    out, _, _ = _forward(q, k, v, causal, window, chunk)
    B, Sq, KV, G, hd = out.shape
    return out.reshape(B, Sq, KV * G, hd).to(q.dtype)
