#!/usr/bin/env python3
"""First and last loss of ``tests/test_fault_tolerance.py``'s
``test_loss_decreases`` case over several seeds, on either framework.

    PYTHONPATH=src python scripts/train_loss_seeds.py --side reference [--seeds 8]
    PYTHONPATH=src python scripts/train_loss_seeds.py --side port [--seeds 8] [--device cpu]

The case: yi-6b's smoke config in its own dtype (bfloat16), batch 2 ×
16 tokens, 12 steps of the default AdamW schedule (its warm-up is 100
steps, so the learning rate climbs to 12 % of its peak) through the
framework's ``TrainLoop``.  For seed s the parameters are drawn with
seed s and the synthetic batches with seed s; seed 0 is the test's own
case.  ``--side reference`` runs ``repro`` (JAX), ``--side port`` runs
``repro_torch`` from its own seeded parameters; each process imports
only its side's package.  It prints one JSON line a seed (first loss,
last loss, their difference, whether the last is below the first) and
a summary line: how many seeds pass and the mean and spread of the
difference.
"""
from __future__ import annotations

import argparse
import json
import statistics

STEPS, BATCH, SEQ = 12, 2, 16


def reference_run(seed: int, _device: str) -> list[float]:
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import TrainLoop

    loop = TrainLoop(get_smoke_config("yi_6b"), make_host_mesh(), batch=BATCH, seq_len=SEQ,
                     seed=seed)
    init = loop.init_state
    loop.init_state = lambda: init(seed)
    return [float(x) for x in loop.run(steps=STEPS, log_every=0)["losses"]]


def port_run(seed: int, device: str) -> list[float]:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.launch.train import TrainLoop

    loop = TrainLoop(get_smoke_config("yi_6b"), make_host_mesh(device=device), batch=BATCH,
                     seq_len=SEQ, seed=seed)
    init = loop.init_state
    loop.init_state = lambda: init(seed)
    return [float(x) for x in loop.run(steps=STEPS, log_every=0)["losses"]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("reference", "port"), required=True)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args(argv)
    run = reference_run if args.side == "reference" else port_run
    deltas = []
    for seed in range(args.seeds):
        losses = run(seed, args.device)
        delta = losses[-1] - losses[0]
        deltas.append(delta)
        print(json.dumps({"side": args.side, "seed": seed, "first": losses[0],
                          "last": losses[-1], "delta": delta, "decreased": delta < 0}),
              flush=True)
    print(json.dumps({"side": args.side, "seeds": args.seeds,
                      "decreased": sum(d < 0 for d in deltas),
                      "delta_mean": statistics.mean(deltas),
                      "delta_stdev": statistics.stdev(deltas) if len(deltas) > 1 else 0.0}))


if __name__ == "__main__":
    main()
