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
reference's rule replicates it: every process steps on all of it.  The
MoE routes each shard's rows as the global batch's
(``models.moe.DataRoute``).

On a 'model' axis past one shard, or with ``fsdp``, the step runs the
parameter layouts of ``launch.sharding.param_pspecs`` (tensor and expert
parallelism, FSDP, ``models.parallel``), with Megatron's sequence
parallelism where the reference's rule turns it on (``sp_spec``).  A
process group's ranks hold only their blocks of the parameters, the
gradients and AdamW's moments; the clip's global norm sums each leaf's
squares over the axes it is split on, block by block in shard order, so
every form takes the same step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import convert
from ..configs import SHAPES, input_specs
from ..launch.mesh import axis_size, dp_axes, make_host_mesh
from ..launch.sharding import _entry, batch_pspecs, layer_layouts, local_block, param_pspecs
from ..models import model_module, parallel
from ..models.moe import DataRoute
from .optimizer import AdamWConfig, abstract_opt_state, adamw_update, sharded_global_norm


def sp_rule(cfg, mesh, seq_len: int, sequence_parallel: bool = True):
    """The reference's sequence-parallel rule: the residual's spec
    (dp, 'model', None) when it is on (not the encoder-decoder, a
    'model' axis past one shard dividing the sequence), else None."""
    model = axis_size(mesh, "model")
    if sequence_parallel and cfg.family != "encdec" and model > 1 and seq_len % model == 0:
        return (_entry(dp_axes(mesh)), "model", None)
    return None


def make_loss_fn(cfg, remat: str = "unit", sp_spec=None, *, mesh=None, layouts=None,
                 data_route=None):
    """``loss(params, batch)`` for ``cfg``'s family: on ``mesh``'s model
    axis (``models.parallel``, sequence-parallel with an ``sp_spec``)
    when one is given, else the one-device loss; ``data_route`` when the
    batch is one data shard's rows."""
    mod = model_module(cfg)
    if mesh is not None:
        pl = parallel.whisper_loss_fn if cfg.family == "encdec" else parallel.loss_fn

        def loss(params, batch):
            sh = parallel.Shard(mesh, layouts=layouts, params=params, sp=sp_spec is not None,
                                data_route=data_route)
            return pl(params, batch, cfg, sh, remat=remat)

        return loss
    if cfg.family == "encdec":
        return functools.partial(mod.loss_fn, cfg=cfg)
    return functools.partial(mod.loss_fn, cfg=cfg, remat=remat, data_route=data_route)


def loss_and_grads(params, batch: dict, *, cfg, remat: str = "unit", loss_fn=None):
    """(loss, {name: gradient}) of ``batch`` at ``params``, which are made
    trainable; a parameter the loss never reads (``lsh_a``) maps to
    ``None``, which :func:`~repro_torch.train.optimizer.adamw_update`
    reads as zeros.  ``loss_fn`` defaults to :func:`make_loss_fn`'s."""
    params.requires_grad_(True)
    names, tensors = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = (loss_fn or make_loss_fn(cfg, remat))(params, batch)
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


def shard_losses_and_grads(params, batch: dict, mesh, *, cfg, remat: str = "unit",
                           parallel_path: bool = False, layouts=None, sp_spec=None
                           ) -> tuple[list, list]:
    """Each local shard p of ``mesh``'s data axis takes rows
    [p·B/P, (p+1)·B/P) of every batch leaf: its (loss, gradients), one
    pair a local shard, in shard order (one after the other when
    emulated), the MoE routing its rows as the global batch's.  With
    ``parallel_path`` each runs over the model axis (``models.parallel``)."""
    dm = mesh.data
    B = batch["tokens"].shape[0]
    if B % dm.size:
        raise ValueError(f"a batch of {B} rows does not split over {dm.size} shards")
    rows, below, pairs = B // dm.size, {}, []
    for p in dm.local:
        route = DataRoute(dm, p, below) if dm.size > 1 else None
        fn = make_loss_fn(cfg, remat, sp_spec, mesh=mesh if parallel_path else None,
                          layouts=layouts, data_route=route)
        pairs.append(loss_and_grads(params, {k: v[p * rows:(p + 1) * rows]
                                             for k, v in batch.items()},
                                    cfg=cfg, remat=remat, loss_fn=fn))
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


def _data_split(layout) -> bool:
    """Whether a leaf is split over 'data' (FSDP): its gradient comes out
    of the gather's backward already summed over the axis."""
    return "data" in layout.axes()


def tp_loss_and_grads(params, batch: dict, mesh, *, cfg, layouts: dict, remat: str = "unit",
                      sp_spec=None, split: bool = True) -> tuple[torch.Tensor, dict]:
    """The loss and gradients over the ('data', 'model') mesh, averaged
    over 'data': each data shard's rows (``split``; else every shard runs
    the whole batch) over the model axis.  Emulated, the gradients are
    whole tensors averaged as :func:`dp_loss_and_grads` averages them; in
    a group each is the rank's block, an FSDP leaf's already summed over
    'data' by its gather's backward, any other summed here (in shard
    order), then divided by D."""
    dm = mesh.data
    if split:
        losses, grads = shard_losses_and_grads(params, batch, mesh, cfg=cfg, remat=remat,
                                               parallel_path=True, layouts=layouts,
                                               sp_spec=sp_spec)
    else:
        fn = make_loss_fn(cfg, remat, sp_spec, mesh=mesh, layouts=layouts)
        losses, grads = zip(*[loss_and_grads(params, batch, cfg=cfg, remat=remat, loss_fn=fn)])
        losses, grads = list(losses), list(grads)
    n = float(dm.size)
    if dm.emulated:
        k = n if split else 1.0
        mean = {name: None if grads[0][name] is None
                else dm.ordered_sum([g[name] for g in grads]) / k for name in grads[0]}
        return dm.ordered_sum(losses) / k, mean
    mean = {}
    for name, g in grads[0].items():
        if g is None or not (split or _data_split(layouts[name])):
            mean[name] = g  # the whole batch on every data shard: nothing to add
        elif _data_split(layouts[name]):  # summed over 'data' by the gather's backward
            mean[name] = g / n
        else:
            mean[name] = dm.ordered_sum([g]) / n
    return (dm.ordered_sum(losses) / n if split else losses[0]), mean


def dp_train_step(params, opt_state, batch, *, mesh, cfg, opt_cfg: AdamWConfig,
                  remat: str = "unit"):
    """One data-parallel step: :func:`dp_loss_and_grads`, then AdamW once."""
    loss, grads = dp_loss_and_grads(params, batch, mesh, cfg=cfg, remat=remat)
    params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
    metrics["loss"] = loss
    return params, opt_state, metrics


def opt_state_shardings(abstract_params, mesh, *, fsdp: bool = False) -> dict:
    """AdamW's state's specs: ``mu`` and ``nu`` take the parameters'
    (:func:`~repro_torch.launch.sharding.param_pspecs` on the reference's
    stacked tree ``abstract_params``), ``step`` is replicated."""
    specs = param_pspecs(abstract_params, mesh, fsdp=fsdp)
    return {"mu": specs, "nu": specs, "step": ()}


def shard_params(params, mesh, layouts: dict):
    """``params`` (whole tensors) with each leaf replaced by the block this
    process of a group holds (in place; returns the module)."""
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        mod._parameters[leaf] = torch.nn.Parameter(
            local_block(p.detach(), layouts[name], mesh, mesh.coords), requires_grad=False)
    return params


def unshard_params(named: dict, layouts: dict, mesh) -> dict:
    """{name: whole tensor} from a group rank's blocks ``named`` ({name:
    tensor}, or a module's parameters): each split dimension all-gathered
    over its axis, a layer broadcast from its owner; emulated, the
    tensors are whole already."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    if mesh.emulated:
        return {n: t.detach() for n, t in named.items()}
    out = {}
    for name, t in named.items():
        lay, t = layouts[name], t.detach()
        if lay.layer_axes is not None and mesh.axis(lay.layer_axes).size > 1:
            t = mesh.axis(lay.layer_axes).broadcast(t, lay.owner, lay.local_shape(mesh))
        for dim, e in enumerate(lay.spec):
            if e is not None and lay.shape[dim] != t.shape[dim]:
                t = torch.cat(mesh.axis(e).all_gather([t.contiguous()]), dim=dim)
        out[name] = t
    return out


def make_train_step(cfg, mesh=None, *, opt_cfg: AdamWConfig | None = None,
                    batch_specs: dict | None = None, remat: str = "unit",
                    sequence_parallel: bool = True, fsdp: bool = False):
    """The train step on ``mesh`` (the card unless it names the CPU) and
    its tables: ``info`` holds the batch's shapes (``batch``), its specs
    (``batch_pspecs``), whether the step splits it (``data_parallel``),
    whether it runs the parameter layouts (``parallel``: a 'model' axis
    past one shard, or FSDP) with their per-layer view (``layouts``), the
    parameters' and AdamW's specs (``param_pspecs``, ``opt_pspecs``), the
    sequence-parallel spec (``sp_spec``) and the abstract parameters and
    optimizer state on the meta device.  In a process group the step
    takes and updates the rank's blocks (:func:`shard_params`)."""
    mesh = make_host_mesh() if mesh is None else mesh
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
    tp = fsdp or axis_size(mesh, "model") > 1
    layouts = layer_layouts(cfg, mesh, fsdp=fsdp)
    sp_spec = sp_rule(cfg, mesh, shapes["tokens"][1], sequence_parallel) if tp else None

    def fn(params, opt_state, batch):
        got = {name: tuple(np.shape(v)) for name, v in batch.items() if name in shapes}
        if got != shapes:
            raise ValueError(f"make_train_step: batch {got}, the step was made for {shapes}")
        batch = batch_to_device(batch, mesh.device)
        if tp:
            loss, grads = tp_loss_and_grads(params, batch, mesh, cfg=cfg, layouts=layouts,
                                            remat=remat, sp_spec=sp_spec, split=split)
            gnorm = sharded_global_norm(grads, layouts, mesh)
            params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                      grad_norm=gnorm)
            metrics["loss"] = loss
            return params, opt_state, metrics
        if split:
            return dp_train_step(params, opt_state, batch, mesh=mesh, cfg=cfg,
                                 opt_cfg=opt_cfg, remat=remat)
        return train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg, remat=remat)

    tree = convert.lm_params_to_tree(cfg, aparams)
    return fn, {"batch": shapes, "batch_pspecs": specs, "data_parallel": split,
                "parallel": tp, "layouts": layouts, "sp_spec": sp_spec,
                "param_pspecs": param_pspecs(tree, mesh, fsdp=fsdp),
                "opt_pspecs": opt_state_shardings(tree, mesh, fsdp=fsdp),
                "abstract_params": aparams, "abstract_opt": abstract_opt_state(aparams)}
