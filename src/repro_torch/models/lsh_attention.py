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

``lsh_decode_attention_sharded`` is the reference's distributed form
for a KV cache whose sequence is split over the mesh's data axis, or
over the combined ('data', 'model') axis in data-major order (the
long-context decode at batch 1): the paper's tournament merge.  Each
shard scores its own slice of ``pk`` and keeps its top-⌈T/P⌉; only the
selected keys, values and their valid flags cross the wire, gathered in
shard order, and the softmax runs over the P·⌈T/P⌉ gathered keys.

In the reference this is ``jnp`` code, not a Pallas kernel, so here it
is plain PyTorch; a hand-written Hopper kernel fusing the three steps is
queued as speed work.
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


def _shard_blocks(am, t: torch.Tensor) -> list[tuple[int, torch.Tensor]]:
    """(shard, block) for each shard this process holds of a cache leaf
    split along its sequence (dim 1) over the axis mesh ``am``: views of
    the whole tensor when emulated, the rank's own block in a group."""
    if am.emulated:
        Sl = t.shape[1] // am.size
        return [(p, t[:, p * Sl:(p + 1) * Sl]) for p in am.local]
    return [(am.rank, t)]


def seq_shards(mesh, axis) -> int:
    """P, the shard count of the sequence axes ``axis`` (a name or a
    tuple of names) of ``mesh``."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    Pn = 1
    for a in axes:
        Pn *= mesh.shape[a]
    return Pn


def lsh_decode_attention_sharded(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, Smax, KV, hd) emulated, a rank's (B, Smax/P, KV, hd) block in a group
    v: torch.Tensor,
    pk: torch.Tensor,  # (B, ·, KV, m), split as k
    lsh_a: torch.Tensor,
    *,
    kv_len: torch.Tensor | int,
    topk: int,
    mesh,
    axis: str | tuple = "data",
    return_positions: bool = False,
):
    """The tournament merge over the sequence shards of ``mesh``'s
    ``axis`` (the reference's shard_map body, run for each local shard):
    'data', or ('data', 'model'), whose shards are data-major.

    Shard p holds rows [p·Sl, (p+1)·Sl); rows ≥ ``kv_len`` are masked to
    −inf and stay in the gathered set with a False flag, which the
    verify masks with −1e30.  The estimate follows the reference's
    dtypes: ``q·A`` accumulated in float32, the group query cast to the
    cache's dtype, the product with ``pk`` accumulated in float32 (on a
    float32 cache at P = 1 this is :func:`lsh_decode_attention` bit for
    bit).  With ``return_positions`` it also returns the (B, KV, P·Tl)
    global cache positions gathered, in shard order."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Pn = seq_shards(mesh, axis)
    am = mesh.axis(axis)
    if am.size != Pn:
        raise ValueError(f"sequence axes of {Pn} shards on an axis of {am.size}")
    Tl = max(1, -(-topk // Pn))  # local budget: ceil(T / P)

    qp = torch.einsum("bqhd,dm->bqhm", q.float(), lsh_a.float())
    qp_g = qp.reshape(B, KV, G, -1).mean(dim=2).to(pk.dtype).float()  # (B, KV, m)
    if am.emulated and k.shape[1] % Pn:
        raise ValueError(f"a cache of {k.shape[1]} rows does not split over {Pn} shards")
    blocks = [_shard_blocks(am, t) for t in (k, v, pk)]
    cands = []
    for (p, kb), (_, vb), (_, pkb) in zip(*blocks):
        Sl = pkb.shape[1]
        if Tl > Sl:
            raise ValueError(f"local budget ceil({topk}/{Pn}) = {Tl} exceeds the shard "
                             f"length {Sl}")
        pos = p * Sl + torch.arange(Sl, device=q.device)
        score = torch.einsum("bskm,bkm->bsk", pkb.float(), qp_g)
        score = score.masked_fill(~(pos < kv_len)[None, :, None], float("-inf"))
        li = top_k_lowest_index(score.transpose(1, 2), Tl)[1]  # (B, KV, Tl)
        li_s = li.transpose(1, 2)[..., None].expand(B, Tl, KV, hd)
        sel = p * Sl + li
        cands.append((torch.gather(kb, 1, li_s).transpose(1, 2),
                      torch.gather(vb, 1, li_s).transpose(1, 2),
                      (sel < kv_len).to(torch.uint8), sel))
    # only the candidates (keys, values, valid flags) cross the wire, in
    # shard order; the positions only when asked for
    k_all, v_all, ok_all, *pos_all = (
        torch.cat(am.all_gather([c[i] for c in cands]), dim=2)
        for i in range(4 if return_positions else 3))
    qg = q.reshape(B, KV, G, hd).float() * hd**-0.5
    s = torch.einsum("bkgd,bktd->bkgt", qg, k_all.float())
    s = s.masked_fill(~ok_all.bool()[:, :, None, :], -1e30)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", prob, v_all.float()).reshape(B, 1, H, hd).to(q.dtype)
    return (out, pos_all[0]) if return_positions else out


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
