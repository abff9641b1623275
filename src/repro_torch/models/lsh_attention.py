"""PM-LSH retrieval attention — the paper's estimate→select→verify
pipeline applied to long-context decode, the port of
``repro.models.lsh_attention`` (``lsh_decode_attention`` and the dense
oracle ``lsh_attention_reference``).

  estimate  attention scores from the m-dim PROJECTED keys cached beside
            k and v: E[⟨q',k'⟩] = m·⟨q,k⟩, so selection ranks by the
            projected inner product, in float32.
  select    the top-T candidates per (batch, kv head); ties go to the
            LOWEST cache position, as ``lax.top_k`` breaks them (a
            stable descending sort: ``torch.topk`` promises no order).
            Ties are common: with T > kv_len the masked −inf rows tie.
  verify    exact attention over the T gathered keys (global softmax),
            gathered along the sequence axis of the (B, Smax, KV, hd)
            cache without a transposed copy of it.

In the reference this is ``jnp`` code, not a Pallas kernel, so here it
is plain PyTorch; a hand-written Hopper kernel fusing the three steps is
queued as speed work.  The sharded form (the tournament merge) comes
with more than one card (ROADMAP A12d).
"""
from __future__ import annotations

import torch


def top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest, descending, ties
    to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lsh_select(q: torch.Tensor, pk: torch.Tensor, lsh_a: torch.Tensor, *,
               kv_len: torch.Tensor | int, topk: int) -> torch.Tensor:
    """Estimate and select: the (B, KV, T) cache positions of the top-T
    projected inner products, T = min(topk, Smax), rows ≥ kv_len masked."""
    B, _, H, _ = q.shape
    _, Smax, KV, m = pk.shape
    G = H // KV
    T = min(topk, Smax)

    # --- estimate: projected inner products (per kv head, shared across
    # the G query heads in its group — candidates are per (B, KV))
    qp = torch.einsum("bqhd,dm->bqhm", q.float(), lsh_a.float())  # (B, 1, H, m)
    qp_g = qp.reshape(B, KV, G, m).mean(dim=2)  # (B, KV, m) group query proj
    score_est = torch.einsum("bskm,bkm->bsk", pk.float(), qp_g)  # ⟨q',k'⟩ ∝ m·⟨q,k⟩

    # mask invalid cache rows, then select the top-T estimated scores
    pos = torch.arange(Smax, device=q.device)
    score_est = score_est.masked_fill(~(pos < kv_len)[None, :, None], float("-inf"))
    return top_k_lowest_index(score_est.transpose(1, 2), T)[1]


def lsh_decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)   — decode step
    k: torch.Tensor,  # (B, Smax, KV, hd)
    v: torch.Tensor,  # (B, Smax, KV, hd)
    pk: torch.Tensor,  # (B, Smax, KV, m) — cached projected keys
    lsh_a: torch.Tensor,  # (hd, m) 2-stable projection
    *,
    kv_len: torch.Tensor | int,
    topk: int,
) -> torch.Tensor:
    """Returns (B, 1, H, hd) attention output over the LSH-selected set."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    idx = lsh_select(q, pk, lsh_a, kv_len=kv_len, topk=topk)  # (B, KV, T)
    T = idx.shape[-1]

    # --- verify: exact attention over the gathered candidates, gathered
    # along the SEQ axis of the cache directly
    idx_s = idx.transpose(1, 2)[..., None]  # (B, T, KV, 1)
    k_sel = torch.gather(k, 1, idx_s.expand(B, T, KV, hd)).transpose(1, 2)
    v_sel = torch.gather(v, 1, idx_s.expand(B, T, KV, hd)).transpose(1, 2)
    sel_valid = idx < kv_len  # (B, KV, T)

    qg = q.reshape(B, KV, G, hd).float() * hd**-0.5
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_sel.float())
    s = s.masked_fill(~sel_valid[:, :, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v_sel.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def lsh_attention_reference(q, k, v, *, kv_len) -> torch.Tensor:
    """Dense-attention oracle for tests (what LSH attention approximates
    as T → kv_len)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float() * hd**-0.5
    kf = k.float().transpose(1, 2)  # (B, KV, S, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg, kf)
    valid = torch.arange(k.shape[1], device=q.device)[None, None, None, :] < kv_len
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float().transpose(1, 2))
    return out.reshape(B, 1, H, hd).to(q.dtype)
