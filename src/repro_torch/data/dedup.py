"""Near-duplicate detection for training corpora via PM-LSH CP search
(the port of ``repro.data.dedup``).

This is the paper's c-ACP query employed as a production data-pipeline
stage: embed each document (any fixed-dim embedding — here a hashed
bag-of-ngrams so the stage is self-contained), then ask PM-LSH for all
pairs within a distance threshold; one member of each near-dup pair is
dropped.  Candidate generation cost follows Theorem 3 (O(βn²) worst
case, far less in practice) instead of the O(n²d) exact join.

The projection runs on ``device`` (the card by default, raising where
CUDA is absent); the PM-tree and Algorithm 4 run on the host, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cp import PMLSH_CP

__all__ = ["embed_docs", "find_near_duplicates", "dedup_mask"]


def embed_docs(token_docs: list[np.ndarray], dim: int = 64,
               seed: int = 0) -> np.ndarray:
    """Hashed bag-of-bigrams embedding, L2-normalized (deterministic)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(token_docs), dim), np.float32)
    for i, doc in enumerate(token_docs):
        doc = np.asarray(doc, np.int64)
        bi = doc[:-1] * 1_000_003 + doc[1:]
        out[i, bi % dim] += 1.0
        out[i, (bi // dim) % dim] += 0.5
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


def find_near_duplicates(
    embeddings: np.ndarray,
    *,
    threshold: float = 0.1,
    k_pairs: int | None = None,
    c: float = 2.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[tuple[int, int, float]]:
    """Return (i, j, distance) pairs with distance ≤ threshold, found via
    the radius-filtering c-ACP query."""
    n = embeddings.shape[0]
    k_pairs = k_pairs or max(16, n // 4)
    cp = PMLSH_CP(embeddings, c=c, m=min(15, embeddings.shape[1]), seed=seed,
                  device=device)
    res = cp.cp_query(k=k_pairs)
    out = []
    for (i, j), d in zip(res.pairs, res.distances):
        if d <= threshold:
            out.append((int(i), int(j), float(d)))
    return out


def dedup_mask(n_docs: int, dup_pairs: list[tuple[int, int, float]]) -> np.ndarray:
    """Boolean keep-mask dropping the higher-index member of each pair."""
    keep = np.ones(n_docs, bool)
    for i, j, _ in dup_pairs:
        keep[max(i, j)] = False
    return keep
