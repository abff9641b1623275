"""The train step: loss → gradients → AdamW, the port of
``repro.train.train_step``.

``make_train_step(cfg, mesh)`` returns ``(fn, info)`` with
``fn(params, opt_state, batch) -> (params, opt_state, metrics)``: the
parameters and the optimizer state are updated in place (the
counterpart of the reference's donated buffers) and come back.

On a mesh whose data axis is P > 1 it is data-parallel, as the
reference's GSPMD step is over a batch split by ``batch_pspecs``: each
shard (every one when emulated, the rank's own in a group) computes the
loss and gradients of its rows of the global batch, both are averaged
through the mesh, and AdamW runs once on the mean, the same in every
process.  A batch that does not divide the axis is replicated, as the
reference's rule replicates it: every process steps on all of it.
FSDP and tensor parallelism over a ``model`` axis are ROADMAP A12d3, and
sequence parallelism, which needs ``model > 1``, is a no-op here as it
is in the reference at ``model = 1``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import SHAPES, input_specs
from ..launch.mesh import axis_size, make_host_mesh
from ..launch.sharding import batch_pspecs
from ..models import model_module
from .optimizer import AdamWConfig, abstract_opt_state, adamw_update


def make_loss_fn(cfg, remat: str = "unit"):
    """``loss(params, batch)`` for ``cfg``'s family."""
    mod = model_module(cfg)
    if cfg.family == "encdec":
        return functools.partial(mod.loss_fn, cfg=cfg)
    return functools.partial(mod.loss_fn, cfg=cfg, remat=remat)


def loss_and_grads(params, batch: dict, *, cfg, remat: str = "unit"):
    """(loss, {name: gradient}) of ``batch`` at ``params``, which are made
    trainable; a parameter the loss never reads (``lsh_a``) maps to
    ``None``, which :func:`~repro_torch.train.optimizer.adamw_update`
    reads as zeros."""
    params.requires_grad_(True)
    names, tensors = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = make_loss_fn(cfg, remat)(params, batch)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), dict(zip(names, grads))


def train_step(params, opt_state, batch, *, cfg, opt_cfg: AdamWConfig, remat: str = "unit"):
    loss, grads = loss_and_grads(params, batch, cfg=cfg, remat=remat)
    params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
    metrics["loss"] = loss
    return params, opt_state, metrics


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays (the pipeline's) or tensors → tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def shard_losses_and_grads(params, batch: dict, mesh, *, cfg, remat: str = "unit"
                           ) -> tuple[list, list]:
    """Each local shard p of ``mesh``'s data axis takes rows
    [p·B/P, (p+1)·B/P) of every batch leaf: its (loss, gradients), one
    pair a local shard, in shard order."""
    dm = mesh.data
    B = batch["tokens"].shape[0]
    if B % dm.size:
        raise ValueError(f"a batch of {B} rows does not split over {dm.size} shards")
    rows = B // dm.size
    pairs = [loss_and_grads(params, {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()},
                            cfg=cfg, remat=remat) for p in dm.local]
    return [loss for loss, _ in pairs], [g for _, g in pairs]


def dp_loss_and_grads(params, batch: dict, mesh, *, cfg, remat: str = "unit"
                      ) -> tuple[torch.Tensor, dict]:
    """The mean over the data axis of :func:`shard_losses_and_grads`:
    the loss and each gradient summed over the shards
    (``DataMesh.psum``) and divided by P, the same in every process."""
    dm = mesh.data
    losses, grads = shard_losses_and_grads(params, batch, mesh, cfg=cfg, remat=remat)
    n = float(dm.size)
    mean = {name: None if grads[0][name] is None else dm.psum([g[name] for g in grads]) / n
            for name in grads[0]}
    return dm.psum(losses) / n, mean


def dp_train_step(params, opt_state, batch, *, mesh, cfg, opt_cfg: AdamWConfig,
                  remat: str = "unit"):
    """One data-parallel step: :func:`dp_loss_and_grads`, then AdamW once."""
    loss, grads = dp_loss_and_grads(params, batch, mesh, cfg=cfg, remat=remat)
    params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
    metrics["loss"] = loss
    return params, opt_state, metrics


def make_train_step(cfg, mesh=None, *, opt_cfg: AdamWConfig | None = None,
                    batch_specs: dict | None = None, remat: str = "unit",
                    sequence_parallel: bool = True, fsdp: bool = False):
    """The train step on ``mesh`` (the card unless it names the CPU) and
    its tables: ``info`` holds the batch's shapes (``batch``), its specs
    (``batch_pspecs``), whether the step splits it (``data_parallel``)
    and the abstract parameters and optimizer state on the meta device."""
    del sequence_parallel  # Megatron-style SP needs model > 1
    mesh = make_host_mesh() if mesh is None else mesh
    if fsdp or axis_size(mesh, "model") > 1:
        raise ValueError("FSDP and a 'model' axis > 1 shard the parameters over several "
                         "cards: ROADMAP A12d3")
    opt_cfg = opt_cfg or AdamWConfig()
    mod = model_module(cfg)
    aparams = mod.abstract_params(cfg)
    if batch_specs is None:
        batch_specs = input_specs(cfg, SHAPES["train_4k"])
    shapes = {name: tuple(s.shape) for name, s in batch_specs.items()}
    specs = batch_pspecs(batch_specs, mesh)
    # split when every batched leaf's rows divide the data axis (a process
    # group of one reduces through it too)
    split = ((axis_size(mesh, "data") > 1 or not mesh.data.emulated)
             and all(s[0] is not None for s in specs.values() if s))

    def fn(params, opt_state, batch):
        got = {name: tuple(np.shape(v)) for name, v in batch.items() if name in shapes}
        if got != shapes:
            raise ValueError(f"make_train_step: batch {got}, the step was made for {shapes}")
        batch = batch_to_device(batch, mesh.device)
        if split:
            return dp_train_step(params, opt_state, batch, mesh=mesh, cfg=cfg,
                                 opt_cfg=opt_cfg, remat=remat)
        return train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg, remat=remat)

    return fn, {"batch": shapes, "batch_pspecs": specs, "data_parallel": split,
                "abstract_params": aparams, "abstract_opt": abstract_opt_state(aparams)}
