"""Unified decoder LM for the dense / moe / vlm families, the port of
``repro.models.transformer``.

The reference scans a repeating UNIT of blocks over stacked layer
parameters (plus an unrolled remainder) to keep its HLO small; PyTorch
runs eagerly, so the port keeps one parameter module per layer, in the
reference's layer order (unit instance 0's blocks, unit 1's, …, then
the remainder), and loops over them.  ``convert.lm_params_from_numpy``
unstacks the reference's parameters into that order.

Block kinds ``attn``, ``local``, ``moe`` and ``cross`` are here; the
recurrent kinds (``rec``, ``mlstm``, ``slstm``) of the hybrid and ssm
families come with ROADMAP A12b and raise until then.

Caches are a list with one dict per layer, {"k", "v"[, "pk"]} of shape
(B, Smax, KV, ·), written in place by ``forward``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .moe import init_moe, moe_apply

PENDING_KINDS = ("rec", "mlstm", "slstm")

# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------


def layer_plan(cfg) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """Returns (unit pattern, n_units, remainder kinds)."""
    if cfg.family == "moe":
        unit = ("moe",)
    elif cfg.family == "vlm":
        ce = cfg.cross_attn_every
        unit = ("attn",) * (ce - 1) + ("cross",)
    elif cfg.family == "hybrid":
        unit = cfg.block_pattern or ("rec", "rec", "local")
    elif cfg.family == "ssm":
        unit = cfg.block_pattern or ("mlstm", "slstm")
    else:
        unit = ("attn",)
    n_units = cfg.n_layers // len(unit)
    rest_n = cfg.n_layers - n_units * len(unit)
    rest = tuple(unit[i % len(unit)] for i in range(rest_n))
    return unit, n_units, rest


def layer_kinds(cfg) -> tuple[str, ...]:
    """Every layer's block kind in order; raises for kinds not ported yet."""
    unit, n_units, rest = layer_plan(cfg)
    kinds = unit * n_units + rest
    pending = sorted(set(kinds) & set(PENDING_KINDS))
    if pending:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs block kinds {pending}, which the port "
            "does not have yet: the hybrid, ssm and encdec families come with "
            "ROADMAP A12b")
    return kinds


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _init_block(kind: str, gen, cfg, device: torch.device) -> L.Params:
    def ln():
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)

    def mlp():
        return L.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device=device)

    if kind in ("attn", "local"):
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device),
                        ln2=ln(), mlp=mlp())
    if kind == "moe":
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device),
                        ln2=ln(), moe=init_moe(gen, cfg, device=device))
    if kind == "cross":
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device),
                        lnx=ln(), xattn=L.init_cross_attention(gen, cfg, device=device),
                        ln2=ln(), mlp=mlp())
    raise ValueError(f"unknown block kind {kind}")


class DecoderLM(nn.Module):
    """The parameters of one decoder LM: ``embed`` (Vp, d), ``blocks`` (one
    per layer, ``kinds[i]`` its kind), ``final_norm`` (d,) float32 and
    ``lm_head`` (d, Vp) unless the embeddings are tied."""

    def __init__(self, cfg, blocks, embed, final_norm, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(blocks) != len(self.kinds):
            raise ValueError(f"{len(blocks)} blocks for {len(self.kinds)} layers")
        self.blocks = nn.ModuleList(blocks)
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def init_params(cfg, seed: int = 0, *, device: str | torch.device = "cuda") -> DecoderLM:
    """A :class:`DecoderLM` drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the reference draws from a jax key; the draws
    differ, so tests carry the reference's across)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    kinds = layer_kinds(cfg)
    Vp, d = cfg.padded_vocab(), cfg.d_model
    blocks = [_init_block(kind, gen, cfg, dev) for kind in kinds]
    embed = (L.normal(gen, (Vp, d), dev) * 0.02).to(cfg.dtype)
    lm_head = None if cfg.tie_embeddings else L.dense_init(gen, d, Vp, cfg.dtype, device=dev)
    return DecoderLM(cfg, blocks, embed, torch.ones((d,), dtype=torch.float32, device=dev),
                     lm_head)


def abstract_params(cfg) -> DecoderLM:
    """The parameters on the meta device — shapes only, no allocation."""
    return init_params(cfg, device="meta")


def _block_cache_specs(kind: str, cfg, batch: int, max_seq: int, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def empty(width):
        return torch.empty((batch, max_seq, KV, width), dtype=cfg.dtype, device=device)

    c = {"k": empty(hd), "v": empty(hd)}
    if cfg.lsh_attention and kind != "local":
        c["pk"] = empty(cfg.lsh_m)
    return c


def cache_specs(cfg, batch: int, max_seq: int) -> list[dict]:
    """The decode cache on the meta device: one {"k", "v"[, "pk"]} a layer."""
    return [_block_cache_specs(kind, cfg, batch, max_seq, "meta") for kind in layer_kinds(cfg)]


def init_cache(cfg, batch: int, max_seq: int, *,
               device: str | torch.device = "cuda") -> list[dict]:
    dev = resolve_device(device)
    return [{name: torch.zeros(t.shape, dtype=t.dtype, device=dev) for name, t in c.items()}
            for c in cache_specs(cfg, batch, max_seq)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(kind: str, p, x, cfg, *, positions, cache, cache_index, memory):
    """Pre-norm residual block. Returns (x, cache)."""
    eps = cfg.norm_eps
    window = cfg.window if kind == "local" else 0
    use_lsh = cfg.lsh_attention and kind != "local"
    a, nc = L.attention_apply(
        p["attn"], L.rms_norm(x, p["ln1"], eps), cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        window=window, use_lsh=use_lsh,
    )
    x = x + a
    if kind == "cross":
        x = x + L.cross_attention_apply(p["xattn"], L.rms_norm(x, p["lnx"], eps), memory, cfg)
    h = L.rms_norm(x, p["ln2"], eps)
    x = x + (moe_apply(p["moe"], h, cfg) if kind == "moe" else L.swiglu_apply(p["mlp"], h))
    return x, nc


def forward(
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, S)
    cfg,
    *,
    caches: list[dict] | None = None,
    position0: torch.Tensor | int = 0,
    memory: torch.Tensor | None = None,  # vlm image embeddings (B, M, d)
    remat: str = "unit",  # accepted for the reference's signature; no autograd here
    logits_slice: str = "all",  # "all" | "last" | "hidden"
) -> tuple[torch.Tensor, list[dict] | None]:
    """Returns (logits, caches): float32 logits (B, S or 1, Vp), or the
    final-normed hidden states for ``logits_slice="hidden"``; the caches
    are written in place and returned."""
    del remat
    if logits_slice not in ("all", "last", "hidden"):
        raise ValueError(f"logits_slice={logits_slice!r}")
    kinds = layer_kinds(cfg)
    if caches is not None and len(caches) != len(kinds):
        raise ValueError(f"{len(caches)} layer caches for {len(kinds)} layers")
    B, S = tokens.shape
    x = params.embed[tokens].to(cfg.dtype)
    positions = position0 + torch.arange(S, device=x.device)
    for i, kind in enumerate(kinds):
        x, _ = _block_apply(
            kind, params.blocks[i], x, cfg,
            positions=positions, cache=None if caches is None else caches[i],
            cache_index=position0, memory=memory,
        )
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_slice == "hidden":  # loss paths do their own (chunked) head
        return x, caches
    if logits_slice == "last":
        x = x[:, -1:, :]
    logits = (x @ params.head).float()
    return logits, caches


def prefill(params: DecoderLM, batch: dict, cfg, *, max_seq: int | None = None):
    """Forward pass that fills a KV cache; returns (last_logits, caches)."""
    B, S = batch["tokens"].shape
    caches = init_cache(cfg, B, max_seq or S, device=params.device)
    return forward(params, batch["tokens"], cfg, caches=caches, position0=0,
                   memory=batch.get("image_embeds"), logits_slice="last")


def decode_step(params: DecoderLM, caches: list[dict], batch: dict, cfg):
    """One-token decode against a filled cache.  batch: tokens (B,1),
    position (an int or a 0-d tensor). Returns (logits (B,1,V), caches),
    the caches written in place."""
    return forward(params, batch["tokens"], cfg, caches=caches,
                   position0=batch["position"], memory=batch.get("image_embeds"),
                   logits_slice="last", remat="none")
