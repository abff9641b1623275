#!/usr/bin/env python3
"""Run the port's dry run over every (arch × shape × mesh) cell and print
its table: each cell one ``python -m repro_torch.launch.dryrun`` process
(on the CPU; the meta device needs no card), its record appended to a
JSONL file.

    python3 scripts/torch_dryrun_sweep.py --out build/dryrun_torch.jsonl --jobs 3
    python3 scripts/torch_dryrun_sweep.py --table build/dryrun_torch.jsonl

Table: one row an (arch, shape), each field "single / multi" (one value
where the two meshes agree): status; the rank's argument + temp GB
against the card's 80; the three roofline terms (s) over the rank's
traced FLOPs and bytes and its collective tally (``roofline_hlo``), the
dominant one and MODEL_FLOPS / traced FLOPs; the all-gather and
all-reduce GB the rank's collectives hold; the meta run's seconds
(``compile_s``); whether the train step runs FSDP.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCHS = [
    "qwen3-moe-30b-a3b", "qwen2-moe-a2_7b", "deepseek-67b", "yi-6b",
    "mistral-large-123b", "minitron-8b", "llama32-vision-11b",
    "recurrentgemma-9b", "xlstm-125m", "whisper-base",
]
MESHES = ["single", "multi"]
TIMEOUT_S = 1800.0  # a cell's meta run; the slowest takes ≈ 75 s


def run_one(cell: tuple[str, str, str], out: str) -> str:
    arch, shape, mesh = cell
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out]
    try:
        p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=TIMEOUT_S)
        return f"{arch} {shape} {mesh}: rc {p.returncode}"
    except subprocess.TimeoutExpired:
        with open(out, "a") as f:
            f.write(json.dumps({"arch": arch, "shape": shape, "mesh": mesh,
                                "status": "error", "error": f"timeout {TIMEOUT_S} s"}) + "\n")
        return f"{arch} {shape} {mesh}: timeout"


def _fields(r: dict | None) -> list[str]:
    """The table's fields of one record (status first)."""
    if r is None or r["status"] != "ok":
        status = "not run" if r is None else r["status"]
        if r is not None and r["status"] == "error":
            status += f" ({r['error'][:60]})"
        return [status] + [""] * 10
    mem, rf, c = r["memory"], r["roofline_hlo"], r["collective_bytes"]
    gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
    return ["ok", f"{gb:.2f}", f"{rf['compute_s']:.3g}", f"{rf['memory_s']:.3g}",
            f"{rf['collective_s']:.3g}", rf["dominant"][:-2], f"{rf['useful_flops_ratio']:.3f}",
            f"{c['all-gather'] / 1e9:.1f}", f"{c['all-reduce'] / 1e9:.4f}",
            f"{r['compile_s']:.1f}", "yes" if r["fsdp"] else "no"]


def table(path: str) -> None:
    """One row an (arch, shape), each field "single / multi"."""
    recs = {}
    for line in open(path):
        r = json.loads(line)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    print("| arch | shape | status | arg+temp GB (/80) | compute s | memory s | collective s "
          "| dominant | useful | AG GB | AR GB | meta s | fsdp |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for a in ARCHS:
        for s in SHAPES:
            single, multi = (_fields(recs.get((a, s, m))) for m in MESHES)
            cells = [x if x == y else f"{x} / {y}" for x, y in zip(single, multi)]
            print(f"| {a} | {s} | " + " | ".join(cells) + " |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="run the cells missing from this JSONL, appending")
    ap.add_argument("--table", help="print the table of this JSONL")
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)
    if args.out:
        done = set()
        if os.path.exists(args.out):
            done = {(r["arch"], r["shape"], r["mesh"])
                    for r in map(json.loads, open(args.out))}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in MESHES
                 if (a, s, m) not in done]
        with ThreadPoolExecutor(args.jobs) as pool:
            for line in pool.map(lambda c: run_one(c, args.out), cells):
                print(line, flush=True)
    if args.table:
        table(args.table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
