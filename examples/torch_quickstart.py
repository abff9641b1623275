"""Quickstart on the PyTorch port: build an index through the
``repro_torch.index`` facade, answer batched (c,k)-ANN and (c,k)-ACP
queries, compare with exact answers, and swap backends with one config
field — the twin of ``examples/quickstart.py``, on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import solve_parameters
from repro_torch.device import resolve_device
from repro_torch.index import IndexConfig, available_backends, build_index


def run(device="cuda", build=None) -> list[str]:
    """The tour on ``device``; returns the lines it prints.  ``build``
    (default ``build_index``) is called as ``build(data, config,
    device=..., **overrides)`` for every index the tour makes."""
    dev = resolve_device(device)
    build = build_index if build is None else build
    lines = []
    rng = np.random.default_rng(0)
    # a clustered dataset: 5k points in 128-d
    centers = rng.normal(size=(30, 128)).astype(np.float32) * 5
    data = (centers[rng.integers(0, 30, 5000)]
            + rng.normal(size=(5000, 128)).astype(np.float32) * 0.5)

    # ---- parameters (Eq. 10): c = 1.5, m = 15 hash functions ----------
    params = solve_parameters(c=1.5, m=15)
    lines.append(f"PM-LSH parameters: t={params.t:.3f} α₂={params.alpha2:.4f} "
                 f"β={params.beta:.4f} (success ≥ {params.success_probability:.3f})")
    lines.append(f"registered backends: {', '.join(available_backends())}")

    # ---- (c,k)-ANN via the facade: same call, any backend --------------
    k = 10
    queries = data[rng.integers(0, 5000, 4)] + 0.1  # batch of 4
    exact = np.argsort(np.linalg.norm(data - queries[0], axis=-1))[:k]

    for backend in ("pmtree", "flat"):
        index = build(data, IndexConfig(backend=backend, c=1.5, m=15), device=dev)
        res = index.search(queries, k=k)  # (4, 10) int32 / float32
        recall = len(set(res.indices[0].tolist()) & set(exact.tolist())) / k
        lines.append(f"{backend:7s} ANN (batch of 4): recall={recall:.2f} "
                     f"verified {res.stats.candidates_verified} candidates "
                     f"in {res.stats.rounds} rounds")

    # ---- (c,k)-ACP closest pairs via the same facade -------------------
    cp_index = build(
        data[:1000],
        # T = candidate-pair budget (βn(n-1)/2 + k); the Eq. 10 default
        # at c = 4 is very lean — spend a little more for higher recall
        IndexConfig(backend="pmtree", cp_c=4.0, options={"cp_T": 20_000}),
        device=dev,
    )
    cp_res = cp_index.cp_search(k=5)
    exact_cp = build(data[:1000], backend="nlj", device=dev).cp_search(k=5)
    pair_recall = len(
        {tuple(sorted(p)) for p in cp_res.pairs.tolist()}
        & {tuple(sorted(p)) for p in exact_cp.pairs.tolist()}
    ) / 5
    lines.append(f"\nCP radius-filtering: recall={pair_recall:.2f} "
                 f"ratio={np.mean(cp_res.distances / exact_cp.distances):.4f} "
                 f"verified {cp_res.stats.candidates_verified} of "
                 f"{1000 * 999 // 2} pairs")

    # same call on the engine on the card: Alg. 4's radius filter as
    # pair-join tile masking (the pair_join kernel)
    fused_cp = build(data[:1000], backend="flat", device=dev).cp_search(k=5)
    fused_recall = len(
        {tuple(sorted(p)) for p in fused_cp.pairs.tolist()}
        & {tuple(sorted(p)) for p in exact_cp.pairs.tolist()}
    ) / 5
    lines.append(f"CP fused engine:     recall={fused_recall:.2f} "
                 f"verified {fused_cp.stats.pairs_verified} pairs, "
                 f"pruned {fused_cp.stats.tiles_pruned} tiles")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    for line in run(args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
