"""Where verify_topk's wide path (d > 512) spends its time, on the card.

Builds variants of ``src/repro_torch/kernels/csrc/verify.cu`` beside
``topk.cu`` under ``build/verify_wide/`` (plain nvcc, loaded with
ctypes), and times each at the kNN-LM datastore's shape (n = 16,384,
d = 4096, 64 queries, 1,593 candidates each, k = 8; data from
``--seed``), in turns, forward then backward:

  as_is      the kernel as it is (its ids checked against
             ``ref.verify_topk``);
  no_sums    the consumer warps wait for each stage and free it without
             summing: the producer's ring alone;
  one_row    the producer copies one row a stage: the sums alone.

Then a copy with ``clock64()`` stamps in block 0 prints the mean per
stage of a consumer warp's wait for its stage and of its sums, and the
producer's time from a free slot to the copies issued (clocks, shown as
µs at the card's highest SM clock).  Run from the
root of a checkout on a machine with the card:

    python3 scripts/torch_verify_wide.py [--seed 0]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "verify_wide"
SUMS = ("    if (cols == C) {\n      wide_stage<L, V, false>",
        "    } else {\n      wide_stage<L, V, true>")
VARIANTS = {
    "as_is": [],
    "no_sums": [(SUMS[0], "    if (false) {\n      wide_stage<L, V, false>"),
                (SUMS[1], "    } else if (false) {\n      wide_stage<L, V, true>")],
    "one_row": [("warp_copy(s_ring + (t % kS) * kWideStageFloats, nr,",
                 "warp_copy(s_ring + (t % kS) * kWideStageFloats, min(nr, 1),")],
    "traced": [
        ("template <int L, int V>\n__global__ void __launch_bounds__(kWideThreads, 1)",
         "__device__ unsigned long long g_trace[2560];\n"
         "template <int L, int V>\n__global__ void __launch_bounds__(kWideThreads, 1)"),
        ("        mbar_wait(empty + done % kS, (done / kS) & 1);\n",
         "        mbar_wait(empty + done % kS, (done / kS) & 1);\n"
         "        if (blockIdx.x == 0 && lane == 0 && t < 512) g_trace[t] = clock64();\n"),
        ("                full + t % kS, lane);\n    }\n    return;",
         "                full + t % kS, lane);\n"
         "      if (blockIdx.x == 0 && lane == 0 && t < 512) g_trace[512 + t] = clock64();\n"
         "    }\n    return;"),
        ("    mbar_wait(full + t % kS, (t / kS) & 1);\n    if (t % groups == 0)",
         "    if (blockIdx.x == 0 && threadIdx.x == 0 && t < 512) g_trace[1024 + t] = clock64();\n"
         "    mbar_wait(full + t % kS, (t / kS) & 1);\n    if (t % groups == 0)"),
        ("    const int* st = s_st + (t % kS) * kSt;\n    const int nr",
         "    if (blockIdx.x == 0 && threadIdx.x == 0 && t < 512) g_trace[1536 + t] = clock64();\n"
         "    const int* st = s_st + (t % kS) * kSt;\n    const int nr"),
        ("    __syncwarp();\n    if (lane == 0) mbar_arrive(empty + t % kS);",
         "    __syncwarp();\n"
         "    if (blockIdx.x == 0 && threadIdx.x == 0 && t < 512) g_trace[1024 + 512 * 2 + t] ="
         " clock64();\n"
         "    if (lane == 0) mbar_arrive(empty + t % kS);")],
}
TRACE_READ = ('\nextern "C" int verify_trace_read(unsigned long long* out) {\n'
              "  return cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));\n}\n")


def build(name: str, edits: list) -> ctypes.CDLL:
    src = (CSRC / "verify.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: verify.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "verify.cu").write_text(src + (TRACE_READ if name == "traced" else ""))
    for f in ("common.cuh", "common.cu", "topk.cu"):
        shutil.copy(CSRC / f, out / f)
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(out / "lib.so")]
    run = subprocess.run(cmd + [str(out / f) for f in ("verify.cu", "topk.cu", "common.cu")],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.verify_topk_launch.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.verify_topk_scratch_bytes.argtypes = [I] * 5
    lib.verify_topk_scratch_bytes.restype = ctypes.c_longlong
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    n, d, B, Tc, k = 16_384, 4096, 64, 1593, 8
    data = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32)).to(dev)
    cand = torch.from_numpy(rng.integers(0, n, (B, Tc)).astype(np.int32)).to(dev)
    _, want = ref.verify_topk(data, q, cand, k)

    def call(lib):
        vals = torch.empty(B, k, device=dev)
        ids = torch.empty(B, k, dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = torch.empty(lib.verify_topk_scratch_bytes(n, d, B, Tc, k), dtype=torch.uint8,
                              device=dev)

        def f():
            err = lib.verify_topk_launch(
                data.data_ptr(), q.data_ptr(), cand.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                rows.data_ptr(), scratch.data_ptr(), n, d, B, Tc, k,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"verify_topk_launch: CUDA error {err}")
        return f, ids

    def ms(f, reps=20):
        for _ in range(3):
            f()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            f()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    timed = [name for name in VARIANTS if name != "traced"]
    runs = {name: [] for name in timed}
    for name in timed + timed[::-1]:
        f, ids = call(libs[name])
        runs[name].append(ms(f))
        if name == "as_is" and not torch.equal(ids, want):
            raise SystemExit("as_is: ids differ from ref.verify_topk")
    f, _ = call(libs["traced"])
    f()
    torch.cuda.synchronize()
    tr = np.zeros(2560, np.uint64)
    libs["traced"].verify_trace_read.argtypes = [ctypes.c_void_p]
    if libs["traced"].verify_trace_read(tr.ctypes.data):
        raise SystemExit("verify_trace_read failed")
    tr = tr.astype(np.int64)
    T = int((tr[1536:2048] > 0).sum())  # block 0's stages
    wake, issued, wait, go, done = (tr[i:i + T] for i in (0, 512, 1024, 1536, 2048))
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.split()[0])
    us = 1 / mhz  # µs a clock at the card's highest SM clock
    print(json.dumps({
        "card": card, "shape": [n, d, B, Tc, k], "ms": runs,
        "block0_stages": T, "sm_clock_mhz": mhz,
        "consumer_wait_us": float(np.mean(go - wait) * us),
        "consumer_sums_us": float(np.mean(done - go) * us),
        "producer_issue_us": float(np.mean(issued[3:] - wake[3:]) * us) if T > 3 else None,
        "block0_us": float((done[-1] - wait[0]) * us)}))


if __name__ == "__main__":
    main()
