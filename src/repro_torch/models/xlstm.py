"""xLSTM blocks (arXiv:2405.04517), mLSTM (matrix memory) and sLSTM, the
port of ``repro.models.xlstm``.

mLSTM runs in the reference's CHUNKWISE-PARALLEL form: within a chunk of
L tokens the update is an attention-like dense computation; across
chunks only the (H, dh, dh) matrix state is carried.  A one-token call
is the plain recurrence.  Forget gates are log-sigmoids cumulated in log
space and the input gate a sigmoid (the reference's documented
deviation from the paper's exponential gates).

sLSTM is two linear recurrences, c_t = f c_{t−1} + i z_t and
n_t = f n_{t−1} + i, run by :func:`~repro_torch.models.scan.linear_scan`
with the carried c and n folded into step 0.

States are float32 and written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, dense_init
from .recurrent import softplus
from .scan import linear_scan


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: −softplus(−x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm_block(gen, cfg, dtype=None, *, device: torch.device) -> Params:
    dtype = dtype or cfg.dtype
    d, H = cfg.d_model, cfg.n_heads
    f32 = torch.float32
    return Params(
        w_up=dense_init(gen, d, 2 * d, dtype, device=device),  # [rnn path | gate path]
        w_q=dense_init(gen, d, d, dtype, device=device),
        w_k=dense_init(gen, d, d, dtype, device=device),
        w_v=dense_init(gen, d, d, dtype, device=device),
        w_f=dense_init(gen, d, H, f32, device=device),  # forget gate (per head)
        b_f=torch.full((H,), 3.0, dtype=f32, device=device),  # bias toward remembering
        w_i=dense_init(gen, d, H, f32, device=device),  # input gate
        b_i=torch.zeros((H,), dtype=f32, device=device),
        w_down=dense_init(gen, d, d, dtype, device=device),
    )


def _readout(q, C, n):
    """q: (B,H,dh); C: (B,H,dh_v,dh_k); n: (B,H,dh_k) → (B,H,dh_v).

    h = C·q contracts q with the k-index of C (C[d,e] = Σ v[d]k[e])."""
    h = torch.einsum("bhe,bhde->bhd", q, C)
    denom = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), 1.0)
    return h / denom[..., None]


def _mlstm_chunk(C, n, qb, kb, vb, lfb, igb):
    """One chunk of L tokens: (B, L, H, ·) inputs, the carried (C, n) →
    (out (B, L, H, dh), C, n)."""
    L = qb.shape[1]
    Fc = torch.cumsum(lfb, dim=1)  # (B, L, H) log ∏ f up to t
    Ftot = Fc[:, -1]  # (B, H)
    eF = torch.exp(Fc)[..., None]
    # inter-chunk: h = C·q (q contracts the k-index e)
    h_inter = eF * torch.einsum("blhe,bhde->blhd", qb, C)
    n_inter = eF * n[:, None]  # (B, L, H, dh)
    # intra-chunk: D_ts = exp(F_t − F_s)·i_s for s ≤ t
    ldiff = Fc[:, :, None, :] - Fc[:, None, :, :]  # (B, L, L, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=qb.device))
    D = torch.where(tri[None, :, :, None], torch.exp(ldiff), 0.0) * igb[:, None]
    scores = torch.einsum("blhd,bshd->blsh", qb, kb) * D
    h_intra = torch.einsum("blsh,bshd->blhd", scores, vb)
    n_intra = torch.einsum("blsh,bshd->blhd", D, kb)
    h = h_inter + h_intra
    nvec = n_inter + n_intra
    denom = torch.clamp_min(torch.abs(torch.einsum("blhd,blhd->blh", nvec, qb)), 1.0)
    out = h / denom[..., None]
    # state update
    gain_s = torch.exp(Ftot[:, None] - Fc) * igb  # (B, L, H)
    eT = torch.exp(Ftot)
    C = eT[..., None, None] * C + torch.einsum("blh,blhd,blhe->bhde", gain_s, vb, kb)
    n = eT[..., None] * n + torch.einsum("blh,blhd->bhd", gain_s, kb)
    return out, C, n


def mlstm_block_apply(p, x: torch.Tensor, cfg, state: dict | None = None, chunk: int = 64):
    """x: (B, S, d); state: {"C": (B,H,dh,dh), "n": (B,H,dh)} float32,
    written in place.  S must be 1 or a multiple of min(chunk, S), as the
    reference asserts; anything else raises ``ValueError``.  Returns
    (out, state) — a fresh state for a one-token call without one, as
    the reference's."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    if S != 1 and S % min(chunk, S):
        raise ValueError(f"seq {S} not divisible by mLSTM chunk {min(chunk, S)}")

    up = x @ p["w_up"]
    z, gate = torch.split(up, d, dim=-1)
    q = (z @ p["w_q"]).reshape(B, S, H, dh).float() * dh**-0.5
    k = (z @ p["w_k"]).reshape(B, S, H, dh).float() * dh**-0.5
    v = (z @ p["w_v"]).reshape(B, S, H, dh).float()
    lf = log_sigmoid(x.float() @ p["w_f"] + p["b_f"])  # (B, S, H)
    ig = torch.sigmoid(x.float() @ p["w_i"] + p["b_i"])  # (B, S, H)

    f32 = dict(dtype=torch.float32, device=x.device)
    C0 = state["C"] if state is not None else torch.zeros((B, H, dh, dh), **f32)
    n0 = state["n"] if state is not None else torch.zeros((B, H, dh), **f32)

    if S == 1:  # decode step — plain recurrence
        f = torch.exp(lf[:, 0])  # (B, H)
        C = f[..., None, None] * C0 + ig[:, 0][..., None, None] * (
            v[:, 0][..., :, None] * k[:, 0][..., None, :])
        n = f[..., None] * n0 + ig[:, 0][..., None] * k[:, 0]
        h = _readout(q[:, 0], C, n)[:, None]  # (B, 1, H, dh)
        new_state = {"C": C, "n": n}
    else:
        L = min(chunk, S)
        C, n, outs = C0, n0, []
        for c in range(S // L):
            sl = slice(c * L, (c + 1) * L)
            out, C, n = _mlstm_chunk(C, n, q[:, sl], k[:, sl], v[:, sl], lf[:, sl], ig[:, sl])
            outs.append(out)
        h = torch.cat(outs, dim=1)
        new_state = {"C": C, "n": n} if state is not None else None

    if state is not None:
        state["C"].copy_(new_state["C"])
        state["n"].copy_(new_state["n"])
        new_state = state
    out = h.reshape(B, -1, d).to(x.dtype) * F.silu(gate)
    return out @ p["w_down"], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm_block(gen, cfg, dtype=None, *, device: torch.device) -> Params:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    f32 = torch.float32
    return Params(
        w_z=dense_init(gen, d, d, dtype, device=device),
        w_i=dense_init(gen, d, d, f32, device=device),
        w_f=dense_init(gen, d, d, f32, device=device),
        b_f=torch.full((d,), 3.0, dtype=f32, device=device),
        w_o=dense_init(gen, d, d, dtype, device=device),
        w_down=dense_init(gen, d, d, dtype, device=device),
    )


def slstm_block_apply(p, x: torch.Tensor, cfg, state: dict | None = None):
    """x: (B, S, d); state: {"c": (B, d), "n": (B, d)} float32, written in
    place.  Returns (out, state)."""
    B, S, d = x.shape
    z = torch.tanh((x @ p["w_z"]).float())
    i = torch.sigmoid(x.float() @ p["w_i"])
    f = torch.sigmoid(x.float() @ p["w_f"] + p["b_f"])
    o = torch.sigmoid((x @ p["w_o"]).float())

    # linear recurrences c_t = f c_{t-1} + i z_t ; n_t = f n_{t-1} + i
    iz = i * z
    ii = i
    if state is not None:  # fold the carried c and n into step 0
        ii = i.clone()
        iz[:, 0, :] += f[:, 0] * state["c"]
        ii[:, 0, :] += f[:, 0] * state["n"]
    _, c = linear_scan(f, iz, dim=1)
    _, n = linear_scan(f, ii, dim=1)
    h = o * c / torch.clamp_min(n, 1.0)
    if state is not None:
        state["c"].copy_(c[:, -1])
        state["n"].copy_(n[:, -1])
    return h.to(x.dtype) @ p["w_down"], state


def xlstm_state_specs(cfg, batch: int, kind: str, device="meta") -> dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    if kind == "mlstm":
        return {"C": empty(batch, H, dh, dh), "n": empty(batch, H, dh)}
    return {"c": empty(batch, d), "n": empty(batch, d)}
