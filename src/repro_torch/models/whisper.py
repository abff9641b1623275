"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the port of
``repro.models.whisper``.

The conv/mel frontend is a stub, as in the reference: the caller hands
precomputed frame embeddings (B, n_audio_frames, d_model).  The encoder
is a bidirectional transformer over those frames (RoPE kept, as the
reference keeps it), the decoder a causal transformer with per-layer
cross-attention.  A prefill fills each decoder layer's self-attention KV
cache and computes its cross K/V once; decode reads them.

The cache is {"self": [{"k", "v"}, …], "cross": [{"ck", "cv"}, …]}, one
entry a decoder layer, written in place.  Trained without caches, each
decoder layer is recomputed in the backward, as the reference's scan
body is under ``jax.checkpoint``; ``loss_fn`` is the mean CE over the
full logits.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L


def _init_enc_layer(gen, cfg, device, lsh_gen) -> L.Params:
    def ln():
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)

    return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device, lsh_gen=lsh_gen),
                    ln2=ln(),
                    mlp=L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device=device))


def _init_dec_layer(gen, cfg, device, lsh_gen) -> L.Params:
    def ln():
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)

    return L.Params(ln1=ln(), attn=L.init_attention(gen, cfg, device=device, lsh_gen=lsh_gen),
                    lnx=ln(), xattn=L.init_cross_attention(gen, cfg, device=device),
                    ln2=ln(),
                    mlp=L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device=device))


class EncDecLM(nn.Module):
    """The parameters of the encoder-decoder: ``embed`` (Vp, d),
    ``encoder`` and ``decoder`` (one module a layer), ``enc_norm`` and
    ``final_norm`` (d,) float32 and ``lm_head`` (d, Vp)."""

    def __init__(self, cfg, encoder, decoder, embed, enc_norm, final_norm, lm_head):
        super().__init__()
        if len(encoder) != cfg.encoder_layers or len(decoder) != cfg.n_layers:
            raise ValueError(f"{len(encoder)} + {len(decoder)} layers for "
                             f"{cfg.encoder_layers} + {cfg.n_layers}")
        self.cfg = cfg
        self.encoder = nn.ModuleList(encoder)
        self.decoder = nn.ModuleList(decoder)
        frozen = dict(requires_grad=False)  # requires_grad_() makes them trainable
        self.embed = nn.Parameter(embed, **frozen)
        self.enc_norm = nn.Parameter(enc_norm, **frozen)
        self.final_norm = nn.Parameter(final_norm, **frozen)
        self.lm_head = nn.Parameter(lm_head, **frozen)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, *, device: str | torch.device = "cuda") -> EncDecLM:
    """An :class:`EncDecLM` drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (tests carry the reference's draws across)."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    Vp, d = cfg.padded_vocab(), cfg.d_model
    lsh_gen = L.lsh_generator(seed, dev)
    enc = [_init_enc_layer(gen, cfg, dev, lsh_gen) for _ in range(cfg.encoder_layers)]
    dec = [_init_dec_layer(gen, cfg, dev, lsh_gen) for _ in range(cfg.n_layers)]
    embed = (L.normal(gen, (Vp, d), dev) * 0.02).to(cfg.dtype)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)

    return EncDecLM(cfg, enc, dec, embed, ones(), ones(),
                    L.dense_init(gen, d, Vp, cfg.dtype, device=dev))


def abstract_params(cfg) -> EncDecLM:
    """The parameters on the meta device — shapes only, no allocation."""
    return init_params(cfg, device="meta")


def encode(params: EncDecLM, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, M, d) stub embeddings → encoder memory (B, M, d)."""
    M = frames.shape[1]
    positions = torch.arange(M, device=frames.device)
    x = frames.to(cfg.dtype)
    for p in params.encoder:
        a, _ = L.attention_apply(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                 positions=positions, cache=None, causal=False)  # bidirectional
        x = x + a
        x = x + L.gelu_mlp_apply(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return L.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _dec_layer_apply(p, x, cfg, *, positions, cache, cache_index, memory, cross_kv=None):
    a, _ = L.attention_apply(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                             positions=positions, cache=cache, cache_index=cache_index)
    x = x + a
    h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    if cross_kv is not None:  # decode: cached cross K/V
        B, S, _ = h.shape
        H, hd = cfg.n_heads, cfg.head_dim
        q = (h @ p["xattn"]["wq"]).reshape(B, S, H, hd)
        out = L.chunked_attention(q, cross_kv["ck"], cross_kv["cv"], causal=False)
        x = x + out.reshape(B, S, H * hd) @ p["xattn"]["wo"]
    else:
        x = x + L.cross_attention_apply(p["xattn"], h, memory, cfg)
    return x + L.gelu_mlp_apply(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _head(params: EncDecLM, x: torch.Tensor, cfg, logits_slice: str) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:, :]
    return (x @ params.lm_head).float()


def forward(params: EncDecLM, tokens: torch.Tensor, frames: torch.Tensor, cfg, *,
            caches: dict | None = None, position0: torch.Tensor | int = 0,
            logits_slice: str = "all") -> tuple[torch.Tensor, dict | None]:
    """Train/prefill path: encode ``frames``, decode ``tokens``.  Returns
    float32 logits (B, S or 1, Vp) and the caches, written in place: each
    layer's self K/V at ``position0`` and its cross K/V of the memory."""
    if logits_slice not in ("all", "last"):
        raise ValueError(f"logits_slice={logits_slice!r}: the encoder-decoder has "
                         "'all' and 'last'")
    if caches is not None and not (len(caches["self"]) == len(caches["cross"])
                                   == len(params.decoder)):
        raise ValueError(f"{len(caches['self'])} self and {len(caches['cross'])} cross "
                         f"caches for {len(params.decoder)} decoder layers")
    memory = encode(params, frames, cfg)
    B, S = tokens.shape
    x = L.embed_lookup(params.embed, tokens).to(cfg.dtype)
    positions = position0 + torch.arange(S, device=x.device)
    for i, p in enumerate(params.decoder):
        if caches is None:  # the train path: each layer recomputed in the backward
            x = L.remat_call(functools.partial(_dec_layer_apply, p, cfg=cfg, positions=positions,
                                               cache=None, cache_index=position0,
                                               memory=memory), x)
        else:
            x = _dec_layer_apply(p, x, cfg, positions=positions, cache=caches["self"][i],
                                 cache_index=position0, memory=memory)
    if caches is not None:  # compute + cache the cross K/V once
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        M = memory.shape[1]
        for p, c in zip(params.decoder, caches["cross"]):
            c["ck"].copy_((memory @ p["xattn"]["wk"]).reshape(B, M, KV, hd))
            c["cv"].copy_((memory @ p["xattn"]["wv"]).reshape(B, M, KV, hd))
    return _head(params, x, cfg, logits_slice), caches


def decode_step(params: EncDecLM, caches: dict, batch: dict, cfg):
    """One decoder token; cross-attention reads the cached cross K/V.
    batch: tokens (B, 1), position (an int or a 0-d tensor).  Returns
    (logits (B, 1, Vp), caches), the self caches written in place."""
    tokens, position0 = batch["tokens"], batch["position"]
    S = tokens.shape[1]
    x = L.embed_lookup(params.embed, tokens).to(cfg.dtype)
    positions = position0 + torch.arange(S, device=x.device)
    for p, c_self, c_cross in zip(params.decoder, caches["self"], caches["cross"]):
        x = _dec_layer_apply(p, x, cfg, positions=positions, cache=c_self,
                             cache_index=position0, memory=None, cross_kv=c_cross)
    return _head(params, x, cfg, "last"), caches


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """The decode cache on the meta device: {"self": [{"k", "v"}…],
    "cross": [{"ck", "cv"}…]}, one entry a decoder layer."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim

    def empty(rows):
        return torch.empty((batch, rows, KV, hd), dtype=cfg.dtype, device="meta")

    return {"self": [{"k": empty(max_seq), "v": empty(max_seq)} for _ in range(cfg.n_layers)],
            "cross": [{"ck": empty(cfg.n_audio_frames), "cv": empty(cfg.n_audio_frames)}
                      for _ in range(cfg.n_layers)]}


def init_cache(cfg, batch: int, max_seq: int, *, device: str | torch.device = "cuda") -> dict:
    """Zeroed caches of :func:`cache_specs`' shapes on ``device`` (the
    meta device too, as :func:`init_params` takes it)."""
    dev = resolve_device(device, meta=True)
    return {part: [{n: torch.zeros(t.shape, dtype=t.dtype, device=dev) for n, t in c.items()}
                   for c in layers]
            for part, layers in cache_specs(cfg, batch, max_seq).items()}


def loss_fn(params: EncDecLM, batch: dict, cfg, **_):
    """Mean next-token CE of ``batch`` ({"tokens", "labels", "audio_frames"})
    over the full logits, as the reference's."""
    from .transformer import cross_entropy

    logits, _ = forward(params, batch["tokens"], batch["audio_frames"], cfg)
    return cross_entropy(logits, batch["labels"], cfg.vocab_size)
