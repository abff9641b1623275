"""Batched serving driver: prefill a batch of requests, then decode
greedily — the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cuda]

Uses the model steps of ``repro_torch.serve.serve_step`` (in-place KV
caches, PM-LSH retrieval attention at decode when the config enables
it) on the host mesh, on the card unless ``--device cpu``;
``--model-parallel M`` serves over a 'model' axis of M shards (emulated
on the one device, or a process group's ranks when one is initialised).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..models import model_module
from ..serve.serve_step import make_decode_step, make_prefill, step_form
from ..train.train_step import shard_params
from .mesh import make_host_mesh


def serve_batch(cfg, mesh=None, *, batch: int, prompt_len: int, gen: int,
                max_seq: int | None = None, seed: int = 0, params=None) -> dict:
    """Prefill + greedy decode ``gen`` tokens for a batch of requests.

    The prompts are the reference's (``numpy.random.default_rng(seed)``);
    ``params`` (a ``DecoderLM``, or an ``EncDecLM`` for the
    encoder-decoder, on the mesh's device) are served as given, else
    drawn by ``init_params(cfg, seed)``.  The encoder-decoder's frames are
    zeros (B, n_audio_frames, d), passed on at each step as the
    reference passes them.  Returns the
    reference's keys — ``tokens`` (batch, gen) numpy, ``prefill_s``,
    ``decode_s_per_token`` — and ``logits`` (batch, gen, Vp), the float32
    logits each token was taken from, on the device.
    """
    mesh = make_host_mesh() if mesh is None else mesh
    dev = mesh.device
    mod = model_module(cfg)
    max_seq = max_seq or (prompt_len + gen)
    prefill, _ = make_prefill(cfg, mesh, batch=batch, seq_len=prompt_len, max_seq=max_seq)
    decode, _ = make_decode_step(cfg, mesh, batch=batch, max_seq=max_seq)
    if params is None:
        params = mod.init_params(cfg, seed, device=dev)
    elif params.device != dev:
        raise ValueError(f"params on {params.device}, the mesh on {dev}")
    form = step_form(cfg, mesh, batch=batch, max_seq=max_seq)
    if form["parallel"] and not mesh.emulated:  # a group rank serves its blocks
        params = shard_params(params, mesh, form["layouts"])

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    req = {"tokens": torch.from_numpy(prompts).to(dev)}
    if cfg.family == "vlm":
        req["image_embeds"] = torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                                          dtype=cfg.dtype, device=dev)
    if cfg.family == "encdec":
        req["audio_frames"] = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                                          dtype=cfg.dtype, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, caches = prefill(params, req)
    sync()
    t_prefill = time.perf_counter() - t0

    out_tokens, out_logits = [], []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(gen):
        out_tokens.append(tok[:, 0])
        out_logits.append(logits[:, 0])
        step = {"tokens": tok, "position": prompt_len + i}
        if cfg.family == "vlm":
            step["image_embeds"] = req["image_embeds"]
        if cfg.family == "encdec":
            step["audio_frames"] = req["audio_frames"]
        logits, caches = decode(params, caches, step)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    sync()
    t_decode = (time.perf_counter() - t0) / max(gen, 1)
    tokens = (torch.stack(out_tokens, dim=1).cpu().numpy() if gen
              else np.zeros((batch, 0), np.int32))
    return {
        "tokens": tokens,  # (batch, gen)
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode,
        "logits": (torch.stack(out_logits, dim=1) if gen
                   else torch.zeros((batch, 0, cfg.padded_vocab()), device=dev)),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="prefill a batch of prompts and decode greedily")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(model=args.model_parallel, device=args.device)
    out = serve_batch(cfg, mesh, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, seed=args.seed)
    print(f"{cfg.name}: prefill {out['prefill_s']*1e3:.0f} ms, "
          f"decode {out['decode_s_per_token']*1e3:.1f} ms/token "
          f"(batch {args.batch}, {mesh.device})")
    print("first request tokens:", out["tokens"][0].tolist())


if __name__ == "__main__":
    main()
