"""The dry run of every (arch × shape) cell on the production meshes, the
port of ``repro.launch.dryrun``: one rank's step traced on the meta
device, and the roofline terms for the NVIDIA H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k --mesh single --out results/dryrun_torch.jsonl

The reference lowers and compiles each cell's SPMD program over 256 or
512 forced host devices and reads XLA's analyses.  The port has no
compiler to ask: it runs the cell's own step as rank (0, 0) of the
production mesh (single: ('data', 'model') = (16, 16); multi: the pod
axis folded into 'data', (32, 16), pod-major) on meta tensors — the
parameters, optimizer state, batch rows and caches that rank holds,
from the layouts' ``local_shape`` — with every collective an
:class:`~.mesh.AbstractDataMesh` call that returns the shapes a group
returns and tallies what the port's group form moves.  Per cell it
records, under the reference's keys:

  * memory   the rank's argument bytes (its blocks), what the step
             returns, and the peak of live bytes the step allocates
             above its arguments (a dispatch mode over meta storages);
  * FLOPs    ``torch.utils.flop_counter.FlopCounterMode`` over the
             rank's step: matmuls, convolutions and attention only;
  * bytes    every aten op's inputs read and outputs written (the
             unfused eager program's traffic; views move nothing);
  * collectives the tally, by XLA's five names;
  * the three roofline terms for the H100 (989 TFLOP/s dense bf16,
    3.35 TB/s HBM3, 450 GB/s a direction of NVLink 4) over those values
    and over the reference's analytic costs, and MODEL_FLOPS / FLOPs.

The rank's own coordinates (``rank``) and whether the train step runs
FSDP (``fsdp``) are added.  Nothing here needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..obs.roofline import get_peaks
from .mesh import COLLECTIVES, CollectiveTally, make_abstract_mesh, make_host_mesh

# hardware constants (NVIDIA H100 SXM 80GB)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s (NVIDIA's H100 SXM data sheet)
HBM_BW = get_peaks("cuda").peak_bw  # bytes/s of HBM3 (the port's peaks, obs/roofline.py)
ICI_BW = 450e9  # bytes/s a direction of NVLink 4 (the data sheet's 900 GB/s is both)
HBM_BYTES = 80e9  # the card's memory
MODEL_AXIS = 16  # the production mesh's 'model' axis

_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
               torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def roofline_terms(flops: float, bytes_hbm: float, coll: dict, n_chips: int,
                   model_flops: float) -> dict:
    """All terms are PER-CHIP seconds (a rank's FLOPs, bytes and
    collectives)."""
    ring = lambda b: b * (n_chips - 1) / max(n_chips, 1)
    wire = (
        ring(coll.get("all-gather", 0.0))
        + 2.0 * ring(coll.get("all-reduce", 0.0))
        + ring(coll.get("reduce-scatter", 0.0))
        + coll.get("all-to-all", 0.0)
        + coll.get("collective-permute", 0.0)
    )
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_coll = wire / ICI_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    return {
        **terms,
        "dominant": dom,
        "step_lower_bound_s": bound,
        "model_flops_per_chip": model_flops / max(n_chips, 1),
        "useful_flops_ratio": (model_flops / max(n_chips, 1)) / max(flops, 1.0),
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
    }


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward-only), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def analytic_cell_costs(cfg, shape, n_chips: int, model_axis: int = MODEL_AXIS) -> dict:
    """Analytic FLOPs + HBM bytes per chip for this cell, the reference's
    model:

      train FLOPs  = 8·N·D (fwd 2 + bwd 4 + full-remat fwd 2)
                     + 4·B·S²·heads·hd·L_attn (causal attn fwd+bwd+remat)
      prefill      = 2·N·D + B·S²·heads·hd·L_attn
      decode       = 2·N·B + attention-over-cache (or LSH estimate+verify)
      bytes: params traffic (3 reads bf16 + grad/opt f32 rw for train;
      1 read for serve) + activation residual traffic + KV-cache traffic.
    """
    N = cfg.param_count(active_only=True)
    B, S = shape.global_batch, shape.seq_len
    L_attn = cfg.n_layers
    if cfg.family == "hybrid":
        L_attn = cfg.n_layers // 3  # only the local-attn third
    if cfg.family == "ssm":
        L_attn = 0
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    win = cfg.window or S

    pbytes_chip = 2.0 * N / model_axis  # bf16 params per chip (TP-sharded)

    if shape.kind == "train":
        tokens = B * S
        eff_s = min(S, win)
        attn = 4.0 * B * S * eff_s * H * hd * L_attn
        flops = 8.0 * N * tokens + attn
        act = 16.0 * (tokens / max(n_chips // model_axis, 1)) * d * cfg.n_layers * 2
        bytes_chip = pbytes_chip * 3 + (4.0 * N / model_axis) * 7 + act / model_axis
    elif shape.kind == "prefill":
        tokens = B * S
        eff_s = min(S, win)
        attn = 1.0 * B * S * eff_s * H * hd * L_attn * 2
        flops = 2.0 * N * tokens + attn
        act = 8.0 * (tokens / max(n_chips // model_axis, 1)) * d * cfg.n_layers * 2
        bytes_chip = pbytes_chip + act / model_axis
        # KV cache write traffic
        bytes_chip += 2.0 * tokens * cfg.n_kv_heads * hd * 2 * L_attn / n_chips
    else:  # decode
        flops = 2.0 * N * B
        kvbytes = 2.0 * B * S * cfg.n_kv_heads * hd * 2 * L_attn  # full K+V read
        if cfg.lsh_attention:
            # the paper's path: read m-dim projected keys + T verified
            est = 2.0 * B * S * cfg.n_kv_heads * cfg.lsh_m * L_attn
            ver = 2.0 * B * cfg.lsh_topk * cfg.n_kv_heads * hd * 2 * L_attn
            kvbytes = est + ver
            flops += (
                2.0 * B * S * cfg.n_kv_heads * cfg.lsh_m * L_attn  # estimate
                + 4.0 * B * cfg.lsh_topk * H * hd * L_attn  # verify attn
            )
        elif cfg.family == "hybrid":
            kvbytes = 2.0 * B * min(S, win) * cfg.n_kv_heads * hd * 2 * L_attn
            flops += 4.0 * B * min(S, win) * H * hd * L_attn
        elif L_attn:
            flops += 4.0 * B * S * H * hd * L_attn
        bytes_chip = pbytes_chip + kvbytes / n_chips
    return {"flops_per_chip": flops / n_chips, "bytes_per_chip": bytes_chip}


def fsdp_rule(cfg) -> bool:
    """FSDP when a rank's training state without it exceeds half the
    card: bf16 parameters and gradients and two f32 moments, 12 bytes a
    parameter over the 16-way model axis."""
    return 12.0 * cfg.param_count() / MODEL_AXIS > HBM_BYTES / 2


def production_axes(mesh_kind: str) -> tuple[int, int]:
    """(data, model) of the production mesh as the port runs it: the
    reference's ('pod', 'data', 'model') = (2, 16, 16) folds 'pod' into
    'data', pod-major, as its batch spec over ('pod', 'data') splits."""
    from .mesh import make_production_mesh

    pm = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    return pm.size // pm.shape["model"], pm.shape["model"]


def rank_mesh(data: int, model: int, tally: CollectiveTally | None = None):
    """The mesh rank (0, 0) of a ``data`` × ``model`` mesh runs on the
    meta device: the one-device step's where there is one chip, else
    the abstract rank of :func:`~.mesh.make_abstract_mesh`."""
    if data * model == 1:
        return make_host_mesh(device="meta")
    return make_abstract_mesh(data, model, tally=tally)


# ---------------------------------------------------------------------------
# the rank's step and its arguments
# ---------------------------------------------------------------------------


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree of tensors (modules read
    by their parameters)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        ts = t.parameters() if isinstance(t, torch.nn.Module) else [t]
        for x in ts:
            if isinstance(x, torch.Tensor) and id(x.untyped_storage()) not in seen:
                seen.add(id(x.untyped_storage()))
                total += x.untyped_storage().nbytes()
    return total


def _batch_bytes(specs: dict, mesh) -> int:
    """The rows of the batch the rank holds (``batch_pspecs``' blocks)."""
    from .sharding import batch_pspecs, local_shape

    ps = batch_pspecs(specs, mesh)
    return sum(math.prod(local_shape(tuple(t.shape), ps[k], mesh)) * t.element_size()
               for k, t in specs.items())


def cell_step(cfg, shape, mesh, *, fsdp: bool = False, remat: str = "unit",
              max_seq: int | None = None):
    """``(step, args, arg_bytes)``: the cell's step on ``mesh`` — the
    train step (``make_train_step`` with ``fsdp`` and ``remat``), the
    prefill or the decode step (against ``max_seq`` rows, default the
    shape's) — the meta tensors it takes (the rank's parameter, AdamW
    and cache blocks beside the batch's meta specs, whose rows the step
    takes) and the bytes of the blocks the rank holds."""
    from ..configs import input_specs
    from ..launch.sharding import local_block
    from ..serve.serve_step import fresh_caches, make_decode_step, make_prefill, step_form
    from ..train.train_step import make_train_step, shard_params

    specs = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    group = not mesh.emulated  # a group rank holds its blocks of what the layouts split
    if shape.kind == "train":
        step, info = make_train_step(cfg, mesh, batch_specs=specs, fsdp=fsdp, remat=remat)
        params, opt = info["abstract_params"], info["abstract_opt"]
        if info["parallel"] and group:
            shard_params(params, mesh, info["layouts"])
            opt = {"step": opt["step"], **{
                part: {n: local_block(t, info["layouts"][n], mesh, mesh.coords)
                       for n, t in opt[part].items()} for part in ("mu", "nu")}}
        args, held = (params, opt, specs), (params, opt)
    else:
        max_seq = max_seq or S
        step, info = (make_prefill(cfg, mesh, batch=B, seq_len=S, max_seq=max_seq)
                      if shape.kind == "prefill"
                      else make_decode_step(cfg, mesh, batch=B, max_seq=max_seq))
        form = step_form(cfg, mesh, batch=B, max_seq=max_seq)
        params = info["abstract_params"]
        if form["parallel"] and group:
            shard_params(params, mesh, form["layouts"])
        if shape.kind == "prefill":
            args, held = (params, specs), (params,)
        else:
            caches = fresh_caches(cfg, mesh, batch=B, max_seq=max_seq)
            args, held = (params, caches, specs), (params, caches)
    return step, args, _tensor_bytes(held) + _batch_bytes(specs, mesh)


class _Traffic(TorchDispatchMode):
    """Every aten op's bytes read and written (``bytes``: its tensor
    inputs and outputs; views and uninitialised allocations move none)
    and the peak of live bytes in the storages the ops allocate
    (``peak``): a storage is live from the op that makes it until the
    last tensor on it is gone.  A composite op (an einsum, a reshape, a
    dtype cast, which ``inference_mode`` hands over whole) runs as its
    parts, as ``FlopCounterMode`` runs it, so their allocations count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held = {}

    def _free(self, key: int, nbytes: int) -> None:
        self._held.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        inputs = {t.untyped_storage()._cdata for t in tensors}
        fresh = False
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            tensors.append(t)
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._held:  # a view or an in-place write
                continue
            fresh, n = True, st.nbytes()
            self._held[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
            self.live += n
        self.peak = max(self.peak, self.live)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if (fresh or writes) and func not in _NO_TRAFFIC:
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


def trace(step, args) -> dict:
    """Run ``step(*args)`` on meta tensors under the FLOP counter and
    :class:`_Traffic`: its FLOPs, bytes read and written, the peak of
    live bytes it allocated (``temp``), the bytes it returns and the
    seconds it took."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        out = step(*args)
    return {"flops": float(flops.get_total_flops()), "bytes": float(traffic.bytes),
            "temp": int(traffic.peak), "output": _tensor_bytes(out),
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# a cell's record
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    from ..configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "family": cfg.family}

    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full attention at 500k context (no LSH path)"
        return rec

    data, model = production_axes(mesh_kind)
    n_chips = data * model
    fsdp = shape.kind == "train" and fsdp_rule(cfg)
    tally = CollectiveTally()
    t0 = time.time()
    mesh = rank_mesh(data, model, tally)
    step, args, arg_bytes = cell_step(cfg, shape, mesh, fsdp=fsdp,
                                      remat=os.environ.get("REPRO_REMAT", "unit"))
    t_lower = time.time() - t0
    got = trace(step, args)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": got["output"],
                     "temp_size_in_bytes": got["temp"],
                     "generated_code_size_in_bytes": 0}
    coll = {k: float(tally.bytes[k]) for k in COLLECTIVES}
    rec["collective_counts"] = dict(tally.counts)
    rec["collective_bytes"] = coll
    rec["hlo_flops"] = got["flops"]
    rec["hlo_bytes"] = got["bytes"]
    mflops = model_flops_for_cell(cfg, shape)
    rec["roofline_hlo"] = roofline_terms(got["flops"], got["bytes"], coll, n_chips, mflops)
    ana = analytic_cell_costs(cfg, shape, n_chips)
    rec["analytic"] = ana
    rec["roofline"] = roofline_terms(ana["flops_per_chip"], ana["bytes_per_chip"], coll,
                                     n_chips, mflops)
    rec["params_total"] = cfg.param_count()
    rec["params_active"] = cfg.param_count(active_only=True)
    rec["lower_s"] = round(t_lower, 1)
    rec["compile_s"] = round(got["seconds"], 1)
    rec["rank"] = [0, 0]
    rec["fsdp"] = fsdp
    rec["status"] = "ok"
    return rec


def main(argv=None):
    from ..configs import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    try:
        rec = run_cell(args.arch, args.shape, args.mesh)
    except Exception as e:  # record failures as data, not crashes
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    line = json.dumps(rec)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    sys.exit(0 if rec.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
