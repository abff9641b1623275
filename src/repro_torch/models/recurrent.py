"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
the port of ``repro.models.recurrent``.

The hybrid architecture interleaves two recurrent blocks per local-
attention block ("rec", "rec", "local").  The recurrence

    h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ u_t),
    a_t = exp(−c·softplus(Λ) ⊙ σ(r_t))

is a linear scan, run by :func:`~repro_torch.models.scan.linear_scan`
(the reference's ``associative_scan`` recursion, log-depth); decode
carries the (h, conv-tail) state, written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, normal
from .scan import linear_scan

_C = 8.0  # Griffin's fixed scale on the softplus recurrence gate


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _uniform(gen, shape, lo: float, hi: float, device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return lo + (hi - lo) * u


def init_rglru_block(gen, cfg, dtype=None, *, device: torch.device) -> Params:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    rw = cfg.rnn_width or d
    # Λ init so that a ∈ (0.9, 0.999) at σ(r)=0.5 (Griffin appendix)
    lam_init = _uniform(gen, (rw,), 0.9**2, 0.999**2, device)
    lam = torch.log(torch.expm1(-torch.log(lam_init) / _C))  # softplus⁻¹
    # gates are BLOCK-DIAGONAL (recurrentgemma's BlockDiagonalLinear,
    # n_blocks = n_heads)
    nb = cfg.n_heads
    bs = rw // nb
    std = bs**-0.5
    return Params(
        w_y=dense_init(gen, d, rw, dtype, device=device),  # gate branch
        w_x=dense_init(gen, d, rw, dtype, device=device),  # recurrence branch
        conv_w=(normal(gen, (cfg.conv1d_width, rw), device) * 0.1).to(dtype),
        w_a=(normal(gen, (nb, bs, bs), device) * std).to(dtype),  # recurrence gate r_t
        w_i=(normal(gen, (nb, bs, bs), device) * std).to(dtype),  # input gate i_t
        lam=lam,  # (rw,) float32
        w_out=dense_init(gen, rw, d, dtype, device=device),
    )


def _block_diag_apply(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B, S, rw); w: (nb, bs, bs) block-diagonal → (B, S, rw)."""
    B, S, rw = u.shape
    nb, bs, _ = w.shape
    return torch.einsum("bsnk,nkj->bsnj", u.reshape(B, S, nb, bs), w).reshape(B, S, rw)


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv. u: (B, S, rw); w: (W, rw); tail: (B, W-1, rw).

    The W shifted products are summed left to right from 0, as the
    reference's Python ``sum`` does, so bfloat16 rounds where it does."""
    W = w.shape[0]
    if tail is None:
        up = F.pad(u, (0, 0, W - 1, 0))
    else:
        up = torch.cat([tail.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = sum(up[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out, up[:, -(W - 1):, :]  # (conv output, new tail)


def _rglru_scan(u: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
                h0: torch.Tensor | None) -> torch.Tensor:
    """u, r, i: (B, S, rw) → h: (B, S, rw) float32 via the linear scan."""
    a = torch.exp(-_C * softplus(lam)[None, None, :] * torch.sigmoid(r.float()))
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        torch.sigmoid(i.float()) * u.float())
    if h0 is not None:  # fold the carried state into step 0
        gated[:, 0, :] += a[:, 0, :] * h0.float()
    _, h = linear_scan(a, gated, dim=1)
    return h


def rglru_block_apply(p, x: torch.Tensor, cfg, state: dict | None = None):
    """Griffin recurrent block. x: (B, S, d); state: {"h": (B, rw) float32,
    "conv": (B, W-1, rw)}, written in place.  Returns (out, state)."""
    y = F.gelu(x @ p["w_y"], approximate="tanh")  # gate branch; jax.nn.gelu's tanh form
    u = x @ p["w_x"]
    tail = state["conv"] if state is not None else None
    u, new_tail = _causal_conv1d(u, p["conv_w"], tail)
    r = _block_diag_apply(u, p["w_a"])
    i = _block_diag_apply(u, p["w_i"])
    h0 = state["h"] if state is not None else None
    h = _rglru_scan(u, r, i, p["lam"], h0)
    out = (y.float() * h).to(x.dtype) @ p["w_out"]
    if state is not None:  # the old tail is read: write the new state over it
        state["h"].copy_(h[:, -1, :])
        state["conv"].copy_(new_tail)
    return out, state


def rglru_state_specs(cfg, batch: int, device="meta") -> dict:
    rw = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.empty((batch, rw), dtype=torch.float32, device=device),
        "conv": torch.empty((batch, cfg.conv1d_width - 1, rw), dtype=cfg.dtype, device=device),
    }
