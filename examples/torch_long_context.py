"""Long-context decode with PM-LSH retrieval attention on the PyTorch port:
decode against a KV cache of 8k positions with a candidate budget of 256
keys per step, and compare against dense attention — the twin of
``examples/long_context.py``, on the card by default.

    PYTHONPATH=src python examples/torch_long_context.py [--device cuda|cpu]

The port has no jit: the decode runs eagerly under
``torch.inference_mode()``, one kernel launch an op, so its ms/token is
not the kind of number the reference's jitted step gives.  On the card
the 8 timed steps are measured with CUDA events (their mean is the
printed ms/token, their median is returned); on the CPU with the host
clock.  The parameters are the port's own seeded draws; given the
reference's, the tokens and logits are the reference's
(``tests/test_torch_long_context.py``).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model_module

STEPS = 8


def run(cfg, label, ctx_len=8192, prefill_len=64, *, device, params=None) -> dict:
    """Prefill ``prefill_len`` seeded tokens into a ``ctx_len`` cache, one
    warm-up decode step, then ``STEPS`` greedy steps, timed.  Returns the
    printed ``line``, ``ms_per_token`` (the timed steps' mean),
    ``ms_median``, ``step_ms``, the 9 steps' input ``tokens`` (the
    prompt's first token, then each greedy token) and the ``first`` and
    ``last`` decode step's logits (1, 1, Vp)."""
    dev = resolve_device(device)
    mod = model_module(cfg)
    params = mod.init_params(cfg, 0, device=dev) if params is None else params
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prefill_len)).astype(np.int32)).to(dev)
    cuda = dev.type == "cuda"
    with torch.inference_mode():
        caches = mod.init_cache(cfg, 1, ctx_len, device=dev)
        _, caches = mod.forward(params, tokens, cfg, caches=caches)
        # the reference feeds the prompt's first token at position
        # prefill_len as its warm-up (compiling) step
        fed = [tokens[:, :1]]
        logits, caches = mod.decode_step(params, caches,
                                         {"tokens": fed[0], "position": prefill_len}, cfg)
        first = logits
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
            ev[0].record()
        t0 = time.perf_counter()
        stamps = [t0]
        for i in range(STEPS):
            fed.append(torch.argmax(logits, -1).to(torch.int32))
            logits, caches = mod.decode_step(
                params, caches, {"tokens": fed[-1], "position": prefill_len + 1 + i}, cfg)
            if cuda:
                ev[i + 1].record()
            else:
                stamps.append(time.perf_counter())
        if cuda:
            torch.cuda.synchronize(dev)
            step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(STEPS)]
            total_ms = ev[0].elapsed_time(ev[STEPS])
        else:
            step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
            total_ms = (stamps[-1] - t0) * 1e3
    dt = total_ms / STEPS / 1e3
    line = (f"{label:>24}: {dt*1e3:7.2f} ms/token "
            f"(cache {ctx_len} × {cfg.n_kv_heads} kv-heads, "
            f"budget {'dense' if not cfg.lsh_attention else cfg.lsh_topk})")
    print(line, flush=True)
    return {"line": line, "ms_per_token": dt * 1e3, "ms_median": statistics.median(step_ms),
            "step_ms": step_ms, "tokens": torch.cat(fed, 1)[0].cpu().numpy(),
            "first": first, "last": logits}


def correlation(a: torch.Tensor, b: torch.Tensor) -> float:
    """Pearson correlation of two logit tensors, in float64 on the host."""
    return float(np.corrcoef(a.double().cpu().numpy().ravel(),
                             b.double().cpu().numpy().ravel())[0, 1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base = get_smoke_config("yi_6b")
    dense = base.replace(lsh_attention=False)
    lsh = base.replace(lsh_attention=True, lsh_topk=256, lsh_m=16)
    l_dense = run(dense, "dense attention", device=dev)["last"]
    l_lsh = run(lsh, "PM-LSH retrieval attn", device=dev)["last"]
    # same weights modulo the untrained lsh projection — logits correlate
    corr = correlation(l_dense, l_lsh)
    print(f"dense↔LSH logit correlation: {corr:.3f} "
          "(short prefill ⇒ every key fits the budget ⇒ ≈ identical)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
