"""The train step: loss → gradients → AdamW, the port of
``repro.train.train_step``.

``make_train_step(cfg, mesh)`` returns ``(fn, info)`` with
``fn(params, opt_state, batch) -> (params, opt_state, metrics)``: the
parameters and the optimizer state are updated in place (the
counterpart of the reference's donated buffers) and come back.  It runs
on the one-device host mesh; FSDP and tensor parallelism over a
``model`` axis come with the multi-card layouts (ROADMAP A12d), and
sequence parallelism, which needs ``model > 1``, is a no-op here as it
is in the reference at ``model = 1``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import SHAPES, input_specs
from ..launch.mesh import axis_size, make_host_mesh
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


def make_train_step(cfg, mesh=None, *, opt_cfg: AdamWConfig | None = None,
                    batch_specs: dict | None = None, remat: str = "unit",
                    sequence_parallel: bool = True, fsdp: bool = False):
    """The train step on ``mesh`` (the card unless it names the CPU) and
    its tables: ``info`` holds the batch's shapes (``batch``) and the
    abstract parameters and optimizer state on the meta device."""
    del sequence_parallel  # Megatron-style SP needs model > 1
    mesh = make_host_mesh() if mesh is None else mesh
    if fsdp or axis_size(mesh, "model") > 1:
        raise ValueError("FSDP and a 'model' axis > 1 shard the parameters over several "
                         "cards: that comes with the multi-card layouts (ROADMAP A12d)")
    opt_cfg = opt_cfg or AdamWConfig()
    mod = model_module(cfg)
    aparams = mod.abstract_params(cfg)
    if batch_specs is None:
        batch_specs = input_specs(cfg, SHAPES["train_4k"])
    shapes = {name: tuple(s.shape) for name, s in batch_specs.items()}

    def fn(params, opt_state, batch):
        got = {name: tuple(np.shape(v)) for name, v in batch.items() if name in shapes}
        if got != shapes:
            raise ValueError(f"make_train_step: batch {got}, the step was made for {shapes}")
        return train_step(params, opt_state, batch_to_device(batch, mesh.device), cfg=cfg,
                          opt_cfg=opt_cfg, remat=remat)

    return fn, {"batch": shapes, "abstract_params": aparams,
                "abstract_opt": abstract_opt_state(aparams)}
