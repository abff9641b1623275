"""AdamW + global-norm clipping, the port of ``repro.train.optimizer``.

The optimizer state is a dict: ``mu`` and ``nu`` map each parameter's
name (``named_parameters()``) to a float32 tensor of its shape, and
``step`` is a 0-d int32 tensor.  The update keeps the reference's
arithmetic, operation for operation, but runs IN PLACE, leaf by leaf and
in slices of at most ``_SLICE`` elements, so that at full width only one
slice's float32 temporaries live at a time (yi-6b's 6.06·10⁹ parameters
and their moments fill most of a card).  A bfloat16 parameter is updated
in float32 and rounded back, as the reference's ``astype`` does.

A parameter the loss never reads (every layer's ``lsh_a``) has no
gradient here where JAX gives zeros: it takes a zero gradient, so
weight decay still shrinks it every step, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..launch.sharding import local_block

_SLICE = 1 << 26  # elements a slice: 256 MiB of float32 temporaries each


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _moments(params: nn.Module, device) -> dict:
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=device or p.device)
            for name, p in params.named_parameters()}


def init_opt_state(params: nn.Module) -> dict:
    """Zero moments beside each parameter, step 0."""
    dev = next(params.parameters()).device
    return {"mu": _moments(params, None), "nu": _moments(params, None),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(abstract_params: nn.Module) -> dict:
    """The state's shapes and dtypes on the meta device, no allocation."""
    return {"mu": _moments(abstract_params, "meta"), "nu": _moments(abstract_params, "meta"),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tensors) -> torch.Tensor:
    """√(Σ over tensors of Σ x²), each in float32; ``None`` counts as 0."""
    sums = [torch.sum(torch.square(x.float())) for x in tensors if x is not None]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _block_sums(g: torch.Tensor, layout, mesh) -> torch.Tensor:
    """Σ x² of the leaf's blocks this process holds, summed over the
    axes the leaf is split on — 'model' first, then 'data', each in
    shard order — so a replicated leaf counts once and every form adds
    the same numbers in the same order.  Emulated, ``g`` is whole and
    its blocks are cut here; in a group it is the rank's block."""
    if mesh.emulated:
        D, M = mesh.data.size, mesh.model.size

        def at(d, m):
            return torch.sum(torch.square(local_block(g, layout, mesh, (d, m)).float()))

        axes = layout.axes()
        ds = range(D) if "data" in axes else (0,)
        ms = range(M) if "model" in axes else (0,)
        total = None
        for d in ds:
            row = None
            for m in ms:
                row = at(d, m) if row is None else row + at(d, m)
            total = row if total is None else total + row
        return total
    s = torch.sum(torch.square(g.float()))
    for axis in ("model", "data"):
        if axis in layout.axes():
            s = mesh.axis(axis).ordered_sum([s])
    return s


def sharded_global_norm(grads: dict, layouts: dict, mesh) -> torch.Tensor:
    """:func:`global_norm` of gradients laid out by ``layouts`` over
    ``mesh`` (whole when emulated, a group rank's blocks otherwise): each
    leaf's squares summed over its blocks (:func:`_block_sums`), the same
    bits in every form and every process."""
    sums = [_block_sums(g, layouts[name], mesh) for name, g in grads.items() if g is not None]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWConfig, params: nn.Module, grads: dict, state: dict, *,
                 grad_norm: torch.Tensor | None = None) -> tuple[nn.Module, dict, dict]:
    """One AdamW step in place: ``params``' tensors and ``state``'s
    ``mu`` / ``nu`` are overwritten and its ``step`` replaced.  ``grads`` maps a
    parameter's name to its gradient (``None`` or absent: zeros).
    ``grad_norm``: the clip's global norm where the gradients are blocks
    of sharded leaves (:func:`sharded_global_norm`).
    Returns (params, state, {"grad_norm", "lr"}) as the reference does."""
    named = dict(params.named_parameters())
    if set(grads) - set(named):
        raise ValueError(f"gradients for no parameter: {sorted(set(grads) - set(named))[:4]}")
    step = state["step"] + 1
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    with torch.no_grad():
        for name, p in named.items():
            g = grads.get(name)
            pf, gf = p.view(-1), None if g is None else g.reshape(-1)
            mf, nf = state["mu"][name].view(-1), state["nu"][name].view(-1)
            for lo in range(0, pf.numel(), _SLICE):
                rows = slice(lo, min(lo + _SLICE, pf.numel()))
                # the reference's upd(p, g, mu, nu), operation for operation
                g_ = (torch.zeros(rows.stop - lo, dtype=torch.float32, device=p.device)
                      if gf is None else gf[rows].float()) * scale
                mu, nu = mf[rows], nf[rows]
                mu.mul_(b1).add_((1 - b1) * g_)  # mu = b1 * mu + (1 - b1) * g
                nu.mul_(b2).add_(((1 - b2) * g_).mul_(g_))  # nu = b2 * nu + (1 - b2) * g * g
                # step_ = mhat / (sqrt(vhat) + eps), mhat = mu / bc1, vhat = nu / bc2
                step_ = torch.div(mu, bc1).div_(torch.div(nu, bc2).sqrt_().add_(cfg.eps))
                p32 = pf[rows].float()  # a view of a float32 parameter, else a copy
                # newp = p - lr * (step_ + weight_decay * p), rounded to p's dtype
                p32.sub_(step_.add_(cfg.weight_decay * p32).mul_(lr))
                if p.dtype != torch.float32:
                    pf[rows] = p32
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
