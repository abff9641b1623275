"""Unified decoder LM for the dense / moe / vlm / hybrid / ssm families,
the port of ``repro.models.transformer`` (whisper's encoder-decoder is
in ``whisper.py``).

The reference scans a repeating UNIT of blocks over stacked layer
parameters (plus an unrolled remainder) to keep its HLO small; PyTorch
runs eagerly, so the port keeps one parameter module per layer, in the
reference's layer order (unit instance 0's blocks, unit 1's, …, then
the remainder), and loops over them.  ``convert.lm_params_from_numpy``
unstacks the reference's parameters into that order.

Caches are a list with one dict per layer, written in place by
``forward``: {"k", "v"[, "pk"]} of shape (B, Smax, KV, ·) for the
attention kinds (a ``local`` layer's without ``pk``), the RG-LRU's
{"h", "conv"} for ``rec``, {"C", "n"} for ``mlstm`` and {"c", "n"} for
``slstm`` — where the reference's stacked cache tree holds them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .moe import init_moe, moe_apply
from .recurrent import init_rglru_block, rglru_block_apply, rglru_state_specs
from .xlstm import (
    init_mlstm_block,
    init_slstm_block,
    mlstm_block_apply,
    slstm_block_apply,
    xlstm_state_specs,
)

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
    """Every layer's block kind, in the reference's layer order."""
    unit, n_units, rest = layer_plan(cfg)
    return unit * n_units + rest


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _init_block(kind: str, gen, cfg, device: torch.device, lsh_gen) -> L.Params:
    def ln():
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)

    def mlp():
        return L.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device=device)

    if kind in ("attn", "local"):
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device, lsh_gen=lsh_gen),
                        ln2=ln(), mlp=mlp())
    if kind == "moe":
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device, lsh_gen=lsh_gen),
                        ln2=ln(), moe=init_moe(gen, cfg, device=device))
    if kind == "cross":
        return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device, lsh_gen=lsh_gen),
                        lnx=ln(), xattn=L.init_cross_attention(gen, cfg, device=device),
                        ln2=ln(), mlp=mlp())
    if kind == "rec":
        return L.Params(ln1=ln(), rec=init_rglru_block(gen, cfg, device=device),
                        ln2=ln(), mlp=mlp())
    if kind == "mlstm":
        return L.Params(ln1=ln(), mlstm=init_mlstm_block(gen, cfg, device=device))
    if kind == "slstm":
        return L.Params(ln1=ln(), slstm=init_slstm_block(gen, cfg, device=device))
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
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    kinds = layer_kinds(cfg)
    Vp, d = cfg.padded_vocab(), cfg.d_model
    lsh_gen = L.lsh_generator(seed, dev)
    blocks = [_init_block(kind, gen, cfg, dev, lsh_gen) for kind in kinds]
    embed = (L.normal(gen, (Vp, d), dev) * 0.02).to(cfg.dtype)
    lm_head = None if cfg.tie_embeddings else L.dense_init(gen, d, Vp, cfg.dtype, device=dev)
    return DecoderLM(cfg, blocks, embed, torch.ones((d,), dtype=torch.float32, device=dev),
                     lm_head)


def abstract_params(cfg) -> DecoderLM:
    """The parameters on the meta device — shapes only, no allocation."""
    return init_params(cfg, device="meta")


def _block_cache_specs(kind: str, cfg, batch: int, max_seq: int, device) -> dict:
    if kind == "rec":
        return rglru_state_specs(cfg, batch, device)
    if kind in ("mlstm", "slstm"):
        return xlstm_state_specs(cfg, batch, kind, device)
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def empty(width):
        return torch.empty((batch, max_seq, KV, width), dtype=cfg.dtype, device=device)

    c = {"k": empty(hd), "v": empty(hd)}
    if cfg.lsh_attention and kind != "local":
        c["pk"] = empty(cfg.lsh_m)
    return c


def cache_specs(cfg, batch: int, max_seq: int) -> list[dict]:
    """The decode cache on the meta device: one dict a layer."""
    return [_block_cache_specs(kind, cfg, batch, max_seq, "meta") for kind in layer_kinds(cfg)]


def init_cache(cfg, batch: int, max_seq: int, *,
               device: str | torch.device = "cuda") -> list[dict]:
    """Zeroed caches of :func:`cache_specs`' shapes on ``device`` (the
    meta device too, as :func:`init_params` takes it)."""
    dev = resolve_device(device, meta=True)
    return [{name: torch.zeros(t.shape, dtype=t.dtype, device=dev) for name, t in c.items()}
            for c in cache_specs(cfg, batch, max_seq)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(kind: str, p, x, cfg, *, positions, cache, cache_index, memory,
                 lsh_shard=None, data_route=None):
    """Pre-norm residual block. Returns (x, cache)."""
    eps = cfg.norm_eps
    if kind == "rec":
        a, nc = rglru_block_apply(p["rec"], L.rms_norm(x, p["ln1"], eps), cfg, state=cache)
        x = x + a
        return x + L.swiglu_apply(p["mlp"], L.rms_norm(x, p["ln2"], eps)), nc
    if kind == "mlstm":
        a, nc = mlstm_block_apply(p["mlstm"], L.rms_norm(x, p["ln1"], eps), cfg, state=cache)
        return x + a, nc
    if kind == "slstm":
        a, nc = slstm_block_apply(p["slstm"], L.rms_norm(x, p["ln1"], eps), cfg, state=cache)
        return x + a, nc
    window = cfg.window if kind == "local" else 0
    use_lsh = cfg.lsh_attention and kind != "local"
    a, nc = L.attention_apply(
        p["attn"], L.rms_norm(x, p["ln1"], eps), cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        window=window, use_lsh=use_lsh, lsh_shard=lsh_shard,
    )
    x = x + a
    if kind == "cross":
        x = x + L.cross_attention_apply(p["xattn"], L.rms_norm(x, p["lnx"], eps), memory, cfg)
    h = L.rms_norm(x, p["ln2"], eps)
    x = x + (moe_apply(p["moe"], h, cfg, data_route) if kind == "moe"
             else L.swiglu_apply(p["mlp"], h))
    return x, nc


def forward(
    params: DecoderLM,
    tokens: torch.Tensor,  # (B, S)
    cfg,
    *,
    caches: list[dict] | None = None,
    position0: torch.Tensor | int = 0,
    memory: torch.Tensor | None = None,  # vlm image embeddings (B, M, d)
    remat: str = "unit",  # "unit" | "dots" | "none"
    logits_slice: str = "all",  # "all" | "last" | "hidden"
    lsh_shard: tuple | None = None,  # (mesh, axis): the caches' sequence is split
    data_route=None,  # moe.DataRoute: tokens are one data shard's rows
) -> tuple[torch.Tensor, list[dict] | None]:
    """Returns (logits, caches): float32 logits (B, S or 1, Vp), or the
    final-normed hidden states for ``logits_slice="hidden"``; the caches
    are written in place and returned.

    Under autograd without caches each unit of the layer plan runs
    under ``remat`` (:func:`~repro_torch.models.layers.remat_call`), as
    the reference's scanned unit body runs under ``jax.checkpoint``; the
    remainder layers are not checkpointed."""
    if logits_slice not in ("all", "last", "hidden"):
        raise ValueError(f"logits_slice={logits_slice!r}")
    if remat not in L.REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {L.REMAT_MODES}")
    kinds = layer_kinds(cfg)
    if caches is not None and len(caches) != len(kinds):
        raise ValueError(f"{len(caches)} layer caches for {len(kinds)} layers")
    unit, n_units, _ = layer_plan(cfg)
    B, S = tokens.shape
    x = L.embed_lookup(params.embed, tokens).to(cfg.dtype)
    positions = position0 + torch.arange(S, device=x.device)

    def run(x, lo: int, hi: int):
        for i in range(lo, hi):
            x, _ = _block_apply(
                kinds[i], params.blocks[i], x, cfg,
                positions=positions, cache=None if caches is None else caches[i],
                cache_index=position0, memory=memory, lsh_shard=lsh_shard,
                data_route=data_route,
            )
        return x

    unit_remat = remat if caches is None else "none"
    for u in range(n_units):
        x = L.remat_call(run, x, u * len(unit), (u + 1) * len(unit), remat=unit_remat)
    x = run(x, n_units * len(unit), len(kinds))
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_slice == "hidden":  # loss paths do their own (chunked) head
        return x, caches
    if logits_slice == "last":
        x = x[:, -1:, :]
    logits = (x @ params.head).float()
    return logits, caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _token_losses(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """lse − the gold logit per token; the gold logit by a one-hot
    contraction, as the reference takes it (a gather over a model-sharded
    vocabulary would all-gather the logits).  The one-hot is
    ``jax.nn.one_hot``'s own definition, ``labels == arange(Vp)``: a label
    outside [0, Vp) gives a zero row, so its token adds its lse alone."""
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long()[..., None] == vocab).to(logits.dtype)
    gold = torch.sum(logits * onehot, dim=-1)
    return lse - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int):
    """Mean CE over tokens; the lse runs over the padded vocabulary, as
    the reference's does (``vocab_size`` is accepted for its signature)."""
    del vocab_size
    return torch.mean(_token_losses(logits, labels))


def _slab_loss(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    return torch.sum(_token_losses((xc @ head).float(), lc))


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 512):
    """CE without the full (B, S, V) logits: slabs of ``chunk`` positions,
    each recomputed in the backward, summed in order from 0 as the
    reference's scan sums them.  A sequence that is not a multiple of the
    chunk takes the full logits, as the reference does."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        return cross_entropy((x @ head).float(), labels, head.shape[1])
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        total = total + L.remat_call(_slab_loss, x[:, rows], head, labels[:, rows])
    return total / (B * S)


def loss_fn(params: DecoderLM, batch: dict, cfg, *, remat: str = "unit", ce_chunk: int = 512,
            data_route=None):
    """Mean next-token CE of ``batch`` ({"tokens", "labels"} (B, S)
    integer tensors, and the vlm's "image_embeds"); ``data_route`` when
    the batch is one data shard's rows (the MoE routes globally)."""
    hidden, _ = forward(params, batch["tokens"], cfg, memory=batch.get("image_embeds"),
                        remat=remat, logits_slice="hidden", data_route=data_route)
    return chunked_cross_entropy(hidden, params.head, batch["labels"], ce_chunk)


def prefill(params: DecoderLM, batch: dict, cfg, *, max_seq: int | None = None):
    """Forward pass that fills a KV cache; returns (last_logits, caches)."""
    B, S = batch["tokens"].shape
    caches = init_cache(cfg, B, max_seq or S, device=params.device)
    return forward(params, batch["tokens"], cfg, caches=caches, position0=0,
                   memory=batch.get("image_embeds"), logits_slice="last")


def decode_step(params: DecoderLM, caches: list[dict], batch: dict, cfg, lsh_shard=None):
    """Decode against a filled cache.  batch: tokens (B, 1), or a (B, S)
    block (a chunked prefill's chunk, a speculative verification),
    position (an int or a 0-d tensor). Returns (logits (B,1,V), caches),
    the caches written in place; ``lsh_shard`` (mesh, axis) when their
    sequence is split (the sharded PM-LSH decode for one token, the
    shards' attention partials merged for a block)."""
    return forward(params, batch["tokens"], cfg, caches=caches,
                   position0=batch["position"], memory=batch.get("image_embeds"),
                   logits_slice="last", remat="none", lsh_shard=lsh_shard)
