"""Fault-tolerant training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 200 [--ckpt-dir DIR] [--device cuda]

Behaviours, as the reference's (tests/test_torch_checkpoint.py):
  * resume from the latest COMMITted checkpoint on (re)start — the
    reference's checkpoints too, since the layout is the same;
  * async checkpointing every ``ckpt_every`` steps;
  * NaN / divergence guard: a non-finite loss drops the step, reloads
    the last committed checkpoint if there is one and goes on (skipping
    the bad batch); it first waits for a pending save to commit, so it
    reloads the newest state saved (the reference's reads whichever save
    has committed by then);
  * straggler watchdog: a step slower than max(30 s, p50 ×
    ``straggler_factor``) is re-issued with the SAME deterministic batch
    (``data.pipeline`` regenerates it).

The train step updates the parameters and AdamW's state in place, so
the loop reads the loss and the deadline after the forward and backward
and BEFORE it applies the update: a NaN step leaves the state untouched,
as the reference's does by keeping the old (params, opt), and a
re-issued step recomputes the same gradients from the same state.  The
deadline times the forward and backward (the reference's times the
whole step).
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..convert import lm_params_from_numpy, lm_params_to_tree, opt_state_from_numpy
from ..data.pipeline import Prefetcher, SyntheticTokens
from ..models import model_module
from ..launch.sharding import layer_layouts, local_block
from ..train.optimizer import (
    AdamWConfig,
    abstract_opt_state,
    adamw_update,
    init_opt_state,
    sharded_global_norm,
)
from ..train.train_step import (
    batch_to_device,
    loss_and_grads,
    shard_params,
    sp_rule,
    tp_loss_and_grads,
    unshard_params,
)
from . import checkpoint as ckpt
from .mesh import make_host_mesh


class TrainLoop:
    def __init__(self, cfg, mesh=None, *, batch: int, seq_len: int,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 straggler_factor: float = 5.0, opt_cfg: AdamWConfig | None = None,
                 seed: int = 0):
        self.cfg = cfg
        self.mesh = make_host_mesh() if mesh is None else mesh
        self.device = self.mesh.device
        self.mod = model_module(cfg)
        self.opt_cfg = opt_cfg or AdamWConfig()
        extras = {"vlm": ("image_embeds", cfg.n_image_tokens),
                  "encdec": ("audio_frames", cfg.n_audio_frames)}.get(cfg.family)
        self.batch_extras = {}
        if extras:  # stub modality inputs: zeros in the model's dtype
            name, rows = extras
            self.batch_extras[name] = torch.zeros((batch, rows, cfg.d_model), dtype=cfg.dtype,
                                                  device=self.device)
        # the train step's two halves, so the loop can check between them;
        # on a 'model' axis past one shard the parameter layouts run
        # (models.parallel) and a group rank holds its blocks
        self.parallel = self.mesh.shape["model"] > 1
        self.layouts = layer_layouts(cfg, self.mesh) if self.parallel else None
        if self.parallel:
            self.grads = functools.partial(
                tp_loss_and_grads, mesh=self.mesh, cfg=cfg, layouts=self.layouts,
                sp_spec=sp_rule(cfg, self.mesh, seq_len),
                split=batch % self.mesh.shape["data"] == 0)
        else:
            self.grads = functools.partial(loss_and_grads, cfg=cfg)
        self.data = SyntheticTokens(cfg.vocab_size, batch, seq_len, seed=seed)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.step_times: list[float] = []
        self.restarts = 0
        self.stragglers = 0

    # -- state ------------------------------------------------------------

    def _local(self, params):
        """The seeded or restored (whole) parameters as this process holds
        them: a group rank's blocks on a 'model' axis past one shard."""
        if self.parallel and not self.mesh.emulated:
            shard_params(params, self.mesh, self.layouts)
        return params

    def init_state(self, seed: int = 0):
        params = self._local(self.mod.init_params(self.cfg, seed, device=self.device))
        return params, init_opt_state(params), 0

    def state_tree(self, params, opt) -> dict:
        """The reference's checkpoint tree of (params, opt), one host copy
        a leaf, whole (a group's blocks gathered first); from meta tensors
        (the abstract state) a structure with no data."""
        step = opt["step"]

        def whole(tensors):
            if self.parallel and not step.is_meta:
                return unshard_params(tensors, self.layouts, self.mesh)
            return tensors

        return {"params": lm_params_to_tree(self.cfg, whole(params)),
                "opt": {"mu": lm_params_to_tree(self.cfg, whole(opt["mu"])),
                        "nu": lm_params_to_tree(self.cfg, whole(opt["nu"])),
                        "step": step if step.is_meta else step.to("cpu", copy=True)}}

    @property
    def writer(self) -> bool:
        """Whether this process writes the checkpoints (rank 0 of a group)."""
        return self.mesh.emulated or self.mesh.world.rank == 0

    def try_resume(self, params, opt):
        """(params, opt, step) from the latest committed checkpoint, else
        the given state at step 0.  The checkpoint is read into host
        memory and moved to the device leaf by leaf, so the device gains
        one copy of the state; a caller that drops its own first (the
        loop passes ``None``) holds one at a time."""
        if not self.ckpt_dir:
            return params, opt, 0
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return params, opt, 0
        aparams = self.mod.abstract_params(self.cfg)
        like = self.state_tree(aparams, abstract_opt_state(aparams))
        state, extra = ckpt.restore(self.ckpt_dir, latest, like, device="cpu")
        self.restarts += 1
        params = self._local(lm_params_from_numpy(self.cfg, state["params"], device=self.device))
        opt = opt_state_from_numpy(self.cfg, state["opt"], device=self.device)
        if self.parallel and not self.mesh.emulated:  # the moments' blocks, as the parameters'
            for part in ("mu", "nu"):
                opt[part] = {n: local_block(t, self.layouts[n], self.mesh, self.mesh.coords)
                             for n, t in opt[part].items()}
        return params, opt, int(extra.get("step", latest))

    # -- stepping ---------------------------------------------------------

    def _deadline(self) -> float:
        if not self.step_times:
            return 600.0
        return max(30.0, float(np.median(self.step_times)) * self.straggler_factor)

    def run(self, steps: int, log_every: int = 10) -> dict:
        """Steps up to ``steps`` from the last committed checkpoint, else
        from the seeded parameters.  Returns the reference's keys and
        ``grad_norms`` and ``step_ms``: each applied step's gradient norm
        and its time, forward to update (CUDA events on the card, the
        host clock on the CPU)."""
        params, opt, start = self.try_resume(None, None)
        if params is None:
            params, opt, start = self.init_state()
        cuda = self.device.type == "cuda"
        pf = Prefetcher(self.data, start_step=start)
        losses, norms, timers = [], [], []
        try:
            step = start
            while step < steps:
                _, batch = pf.get()
                batch = {**batch_to_device(batch, self.device), **self.batch_extras}
                t0 = time.time()
                timer = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else [t0]
                if cuda:
                    timer[0].record()
                loss, grads = self.grads(params, batch)
                loss = float(loss)
                dt = time.time() - t0
                if not np.isfinite(loss):
                    # divergence guard: nothing applied; reload last good state, skip batch
                    del grads
                    if self.checkpointer:  # a pending save commits first
                        self.checkpointer.wait()
                    if self.ckpt_dir and ckpt.latest_step(self.ckpt_dir) is not None:
                        params = opt = None  # the device holds one state at a time
                        params, opt, _ = self.try_resume(None, None)
                    step += 1
                    continue
                if dt > self._deadline():
                    # straggler: deterministic re-issue of the same batch from the same state
                    self.stragglers += 1
                    del grads
                    _, grads = self.grads(params, batch)
                gnorm = (sharded_global_norm(grads, self.layouts, self.mesh) if self.parallel
                         else None)
                params, opt, metrics = adamw_update(self.opt_cfg, params, grads, opt,
                                                    grad_norm=gnorm)
                del grads
                if cuda:
                    timer[1].record()
                else:
                    timer.append(time.time())
                self.step_times.append(dt)
                losses.append(loss)
                norms.append(metrics["grad_norm"])
                timers.append(timer)
                if self.checkpointer and (step + 1) % self.ckpt_every == 0:
                    tree = self.state_tree(params, opt)  # a collective in a group
                    if self.writer:
                        self.checkpointer.save(step + 1, tree, extra={"step": step + 1},
                                               copy=False)
                if log_every and step % log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
                step += 1
        finally:
            pf.close()
            if self.checkpointer:
                self.checkpointer.wait()
        if cuda:
            torch.cuda.synchronize(self.device)
        return {
            "losses": losses,
            "final_loss": losses[-1] if losses else float("nan"),
            "restarts": self.restarts,
            "stragglers": self.stragglers,
            "params": params,
            "opt": opt,
            "grad_norms": [float(n) for n in norms],
            "step_ms": [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in timers],
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="train an LM on synthetic tokens, "
                                             "checkpointing and resuming")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(model=args.model_parallel, device=args.device)
    loop = TrainLoop(cfg, mesh, batch=args.batch, seq_len=args.seq_len,
                     ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every)
    out = loop.run(args.steps)
    print(f"final loss {out['final_loss']:.4f} over {len(out['losses'])} steps "
          f"(restarts={out['restarts']}, stragglers={out['stragglers']}, {mesh.device})")


if __name__ == "__main__":
    main()
