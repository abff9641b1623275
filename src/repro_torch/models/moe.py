"""Mixture-of-Experts layer: top-k routing, shared experts, the port of
``repro.models.moe``.

Dispatch is the reference's capacity-based static-shape scheme
(Switch/GShard style): tokens are scattered into an (E·cap + 1, d)
buffer at their position-in-expert (a cumulative count in flat (token,
slot) order; overflow past ``cap`` goes to the scratch row E·cap), the
expert FFNs run as batched einsums over the expert dim, and outputs are
gathered back weighted by the router's softmaxed gates.

Experts are padded up to a multiple of 16 (``padded_experts``); the
padding experts get a −1e30 router logit so no token routes to them.
The routing top-k breaks ties toward the lowest expert index, as
``lax.top_k`` does.

Over a data axis (:class:`DataRoute`) a shard holds consecutive rows of
the global batch and routes them as the reference's GSPMD step routes
the global (B, S, d): capacity comes from the global token count, and an
assignment's position-in-expert is its local cumulative count plus the
same expert's assignments on the lower shards, an exclusive scan of the
shards' per-expert counts in shard order.  A shard dispatches only its
own kept assignments; the expert FFNs are row-wise, so its rows come out
as the global step's.  Expert parallelism over a 'model' axis (each
shard running E/M experts) is ``models.parallel``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, init_swiglu, normal, swiglu_apply
from .lsh_attention import top_k_lowest_index


def init_moe(gen, cfg, dtype=None, *, device: torch.device) -> Params:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    ffe = cfg.moe_d_ff or cfg.d_ff
    E = cfg.padded_experts()
    p = Params(
        router=dense_init(gen, d, E, torch.float32, device=device),
        # batched expert weights: (E, d, ffe) / (E, ffe, d)
        w_gate=_expert_init(gen, E, d, ffe, dtype, device),
        w_up=_expert_init(gen, E, d, ffe, dtype, device),
        w_down=_expert_init(gen, E, ffe, d, dtype, device),
    )
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(gen, d, ffe * cfg.n_shared_experts, dtype, device=device)
    return p


def _expert_init(gen, e, d_in, d_out, dtype, device):
    std = d_in**-0.5
    return (normal(gen, (e, d_in, d_out), device) * std).to(dtype)


class DataRoute:
    """Shard ``shard`` of the data axis ``dm`` (a ``launch.mesh.DataMesh``)
    routing its rows of a batch split evenly over the axis.  ``below``
    is shared by the shards of one step when emulated (they run in shard
    order): each layer's per-expert counts of the shards run so far.  A
    layer's offsets are kept by the router's identity, so a recomputed
    forward (remat) reuses them."""

    def __init__(self, dm, shard: int, below: dict | None = None):
        self.dm, self.shard = dm, shard
        self.below = {} if below is None else below
        self.offsets: dict = {}

    @property
    def shards(self) -> int:
        return self.dm.size

    def offset(self, key, counts: torch.Tensor) -> torch.Tensor:
        """The (E,) count of each expert's assignments on the lower
        shards, for this shard's ``counts``."""
        if key not in self.offsets:
            if self.dm.emulated:
                off = self.below.get(key, torch.zeros_like(counts))
                self.below[key] = off + counts
            else:
                every = self.dm.all_gather([counts])
                off = torch.zeros_like(counts)
                for c in every[:self.dm.rank]:
                    off = off + c
            self.offsets[key] = off
        return self.offsets[key]


def route(p, xt: torch.Tensor, cfg, data_route: DataRoute | None = None, *,
          router: torch.Tensor | None = None):
    """Top-k routing of the (T, d) rows ``xt``: (gates (T, k) float32,
    expert ids (T, k), the (T, k) dispatch slots into an (E·cap + 1)-row
    buffer — overflow to the scratch row E·cap —, keep (T, k), cap).
    ``router`` stands in for ``p["router"]`` (a gathered copy of it)."""
    T = xt.shape[0]
    router = p["router"] if router is None else router
    E = router.shape[1]
    k = cfg.n_experts_per_token
    shards = 1 if data_route is None else data_route.shards
    cap = _capacity(T * shards, cfg.n_experts, k, cfg.capacity_factor)
    logits = xt.float() @ router  # (T, E)
    # mask padding experts (beyond the real expert count); out of place:
    # "dots" remat keeps this matmul's output for the backward
    if E > cfg.n_experts:
        logits = logits.masked_fill(torch.arange(E, device=xt.device) >= cfg.n_experts, -1e30)
    gates, eidx = top_k_lowest_index(logits, k)  # (T, k)
    gates = torch.softmax(gates, dim=-1)

    # position-in-expert: rank each (token, slot) assignment within its
    # expert by flat order (after the lower shards'); drop overflow
    # beyond capacity
    flat = F.one_hot(eidx, E).reshape(T * k, E)  # (T·k, E)
    pos_in_e = torch.cumsum(flat, dim=0) - 1
    if data_route is not None:
        pos_in_e = pos_in_e + data_route.offset(id(p["router"]), flat.sum(dim=0))
    pos = torch.sum(pos_in_e * flat, dim=1).reshape(T, k)  # (T, k)
    keep = pos < cap
    slot = torch.where(keep, eidx * cap + pos, E * cap)  # overflow → scratch row
    return gates, eidx, slot, keep, cap


def moe_apply(p, x: torch.Tensor, cfg, data_route: DataRoute | None = None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d); ``data_route`` when x is one data
    shard's rows of the global batch."""
    B, S, d = x.shape
    T = B * S
    E = p["router"].shape[1]
    k = cfg.n_experts_per_token
    xt = x.reshape(T, d)
    gates, eidx, slot, keep, cap = route(p, xt, cfg, data_route)

    # scatter tokens into the (E·cap, d) dispatch buffer (+1 scratch row)
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot.reshape(-1),
                   torch.repeat_interleave(xt, k, dim=0)
                   * keep.reshape(T * k, 1).to(x.dtype))
    eb = buf[: E * cap].reshape(E, cap, d)

    # expert FFNs: batched over the expert dim
    h = F.silu(torch.einsum("ecd,edf->ecf", eb, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", eb, p["w_up"])
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"])  # (E, cap, d)
    eo = torch.cat([eo.reshape(E * cap, d), torch.zeros((1, d), dtype=eo.dtype,
                                                         device=eo.device)])

    # gather back, weight by gates
    out = torch.sum(eo[slot] * (gates * keep).to(eo.dtype)[..., None], dim=1)  # (T, d)

    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xt)
    return out.reshape(B, S, d)


def _capacity(tokens: int, n_experts: int, k: int, factor: float) -> int:
    cap = int(tokens * k * factor / max(n_experts, 1))
    return max(cap, 4)
