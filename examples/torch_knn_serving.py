"""kNN-LM-style retrieval serving on the PyTorch port: a PM-LSH index over
model hidden states augments next-token prediction (Khandelwal et al.'s
pattern with the paper's index as the datastore) — the twin of
``examples/knn_serving.py``, on the card by default.  The datastore goes
through the ``repro_torch.index`` facade via ``make_retrieval_step``, so
the backend is a config field; the streaming backend lets the datastore
grow and evict while serving.

    PYTHONPATH=src python examples/torch_knn_serving.py [--device cuda|cpu]

The model's parameters are the port's own seeded draws, so its tokens and
distances are not the reference's; given the reference's parameters and
projection they are (``tests/test_torch_knn_serving.py``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.index import IndexConfig
from repro_torch.models import model_module
from repro_torch.serve.serve_step import make_retrieval_step


def _hidden(mod, params, tokens, cfg) -> torch.Tensor:
    with torch.inference_mode():
        hidden, _ = mod.forward(params, tokens, cfg, logits_slice="hidden")
    return hidden


def run(device="cuda", *, cfg=None, params=None) -> dict:
    """The example on ``device``: ``cfg`` (default yi-6b's smoke config,
    dense attention) and ``params`` (default ``init_params(cfg, 0)``).
    Returns the printed ``lines``; the first search's ``tokens``, ``ids``,
    ``distances`` and ``valid`` mask; the query's datastore ``row`` and
    its next token ``payload``; the ``evicted`` ids; the last search's
    live ``ids_after`` and ``tokens_after``; the grown datastore's size
    ``n``."""
    dev = resolve_device(device)
    cfg = get_smoke_config("yi_6b").replace(lsh_attention=False) if cfg is None else cfg
    mod = model_module(cfg)
    params = mod.init_params(cfg, 0, device=dev) if params is None else params
    rng = np.random.default_rng(0)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    # ---- build the datastore: (hidden state → next token) pairs --------
    corpus_np = rng.integers(0, cfg.vocab_size, (32, 64)).astype(np.int32)
    corpus = torch.from_numpy(corpus_np).to(dev)
    hidden = _hidden(mod, params, corpus, cfg)
    keys = hidden[:, :-1].reshape(-1, cfg.d_model).float().cpu().numpy()
    next_tokens = corpus_np[:, 1:].reshape(-1)
    del hidden
    say(f"datastore: {keys.shape[0]} (hidden → next-token) pairs")

    retrieve, index = make_retrieval_step(
        keys, next_tokens, k=8,
        index_config=IndexConfig(backend="streaming", c=1.5, m=15, seed=0),
        device=dev,
    )

    # ---- serve: blend parametric logits with kNN retrieval -------------
    prompt = corpus[:1, :32]
    q = _hidden(mod, params, prompt, cfg)[:, -1].float().cpu().numpy()  # (1, d)
    with torch.inference_mode():
        logits, _ = mod.forward(params, prompt, cfg, logits_slice="last")

    payload, valid, dists, res = retrieve(q)
    knn_tokens, ok, dists = payload[0], valid[0], dists[0]
    ids = np.asarray(res.indices[0])
    # kernel-weighted vote over retrieved next tokens (masked on validity
    # — padded slots must not vote)
    w = np.where(ok, np.exp(-dists / max(dists[ok].mean(), 1e-6)), 0.0)
    knn_probs = np.zeros(cfg.padded_vocab())
    for t, wi in zip(knn_tokens, w):
        knn_probs[t] += wi
    knn_probs /= knn_probs.sum()

    lam = 0.3
    par_probs = torch.softmax(logits[0, -1], dim=-1).cpu().numpy()
    blended = (1 - lam) * par_probs + lam * knn_probs
    say(f"retrieved next-tokens {knn_tokens.tolist()} "
        f"(distances {np.round(dists, 3).tolist()})")
    say(f"parametric argmax {int(par_probs.argmax())} → "
        f"blended argmax {int(blended.argmax())} (λ={lam})")

    # ---- grow the datastore while serving (streaming backend) ----------
    more_np = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    hidden2 = _hidden(mod, params, torch.from_numpy(more_np).to(dev), cfg)
    new_keys = hidden2[:, :-1].reshape(-1, cfg.d_model).float().cpu().numpy()
    del hidden2
    new_tokens = more_np[:, 1:].reshape(-1)
    new_ids = retrieve.extend(new_keys, new_tokens)
    retrieve.evict(new_ids[:16])  # and retire stale entries, no rebuild
    payload2, valid2, _, res2 = retrieve(q)
    say(f"datastore grew to {index.n} live pairs ({index!r}); "
        f"retrieval still serves: {payload2[0][valid2[0]].tolist()}")
    row = prompt.shape[1] - 1  # the query is corpus row 0's position 31: key 31
    return {"lines": lines, "tokens": knn_tokens, "ids": ids, "distances": dists,
            "valid": ok, "row": row, "payload": int(next_tokens[row]),
            "evicted": np.asarray(new_ids[:16]),
            "ids_after": np.asarray(res2.indices[0])[valid2[0]],
            "tokens_after": payload2[0][valid2[0]], "n": index.n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
