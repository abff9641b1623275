"""Error-feedback int8 gradient compression for the data-parallel
reduction, the port of ``repro.train.grad_compression``.

  * ``quantize`` / ``dequantize``: per-tensor symmetric int8 with a
    float32 scale (127 levels), plus the error-feedback residual that
    keeps the compounded quantization noise unbiased over steps
    (Karimireddy et al., 2019 — EF-SGD);
  * ``compressed_psum`` / ``tree_compress_psum``: int8 payloads summed in
    int32 over the mesh's data axis and dequantized once a step — 4×
    fewer bytes on the wire than float32.

The reductions go through the mesh's :class:`~repro_torch.launch.mesh.
DataMesh` (emulated or a process group): int32 sums and float32 maxima
are exact in any order, and the float32 means (leaves under 1,024
elements, the loss) are summed in shard order after an all-gather, so
both forms give the same bits.  ``torch.round`` and ``jnp.round`` both
round half to even, so on the same gradients and residuals the codes,
scales, rescaled codes, new residuals and mean gradients are the
reference's bit for bit.

A collective takes a list with one value a local shard (every shard
when emulated, the rank's own in a group), as the DataMesh's do;
gradients and residuals are dicts keyed by parameter name.
"""
from __future__ import annotations

import torch

from .optimizer import AdamWConfig, adamw_update
from .train_step import batch_to_device, shard_losses_and_grads

__all__ = ["compress_with_feedback", "compressed_psum", "dequantize", "init_residuals",
           "make_compressed_train_step", "quantize", "rescale_codes", "tree_compress_psum"]

#: leaves smaller than this take the float32 mean uncompressed
MIN_COMPRESSED = 1024


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    # a tensor divisor: on the card a Python-number divisor becomes a
    # multiply by its reciprocal, which can miss the quotient by an ulp
    scale = torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, residual: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EF step: quantize (grad + residual); the residual keeps what was lost."""
    target = grad.float() + residual
    q, scale = quantize(target)
    return q, scale, target - dequantize(q, scale)


def _pmean(mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """The float32 mean over shards, summed in shard order."""
    every = mesh.all_gather([x.float() for x in xs])
    total = every[0]
    for x in every[1:]:
        total = total + x
    return total / torch.tensor(float(mesh.size), dtype=torch.float32, device=total.device)


def rescale_codes(q: torch.Tensor, scale: torch.Tensor, smax: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``scale`` requantized to the common scale ``smax``."""
    return torch.clamp(torch.round(q.float() * (scale / smax)), -127, 127).to(torch.int8)


def compressed_psum(q: list[torch.Tensor], scale: list[torch.Tensor], mesh) -> torch.Tensor:
    """Mean-reduce int8 payloads over the data axis, as the reference
    writes it: the UNRESCALED codes summed in int32, times the largest
    scale, over P (``tree_compress_psum`` rescales first)."""
    total = mesh.psum([x.to(torch.int32) for x in q])
    smax = mesh.pmax(scale)
    n = torch.tensor(float(mesh.size), dtype=torch.float32, device=total.device)
    return total.float() * smax / n


def tree_compress_psum(grads: list[dict], residuals: list[dict], mesh
                       ) -> tuple[dict, list[dict]]:
    """EF-int8 and the sum across a dict of leaves: ``grads`` and
    ``residuals`` hold one dict a local shard.  Returns (the mean
    gradients, one dict, the same in every process; the new residuals, one
    dict a local shard).  A gradient that is ``None`` (a parameter the
    loss never reads) is zeros."""
    mean, new_res = {}, [dict(r) for r in residuals]
    n = torch.tensor(float(mesh.size), dtype=torch.float32)
    for name, r0 in residuals[0].items():
        gs = [torch.zeros_like(r[name]) if g.get(name) is None else g[name]
              for g, r in zip(grads, residuals)]
        if r0.numel() < MIN_COMPRESSED:  # tiny tensors: not worth compressing
            mean[name] = _pmean(mesh, gs)
            continue
        coded = [compress_with_feedback(g, r[name]) for g, r in zip(gs, residuals)]
        # pre-rescale to the common (max) scale so the int32 sum is exact
        smax = mesh.pmax([scale for _, scale, _ in coded])
        qc = [rescale_codes(q, scale, smax) for q, scale, _ in coded]
        total = mesh.psum([x.to(torch.int32) for x in qc])
        mean[name] = total.float() * smax / n.to(total.device)
        for res, (_, _, r) in zip(new_res, coded):
            res[name] = r
    return mean, new_res


def init_residuals(params, mesh=None):
    """Zero float32 residuals keyed by parameter name; with a mesh, one
    such dict a local shard (each shard keeps its own)."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for name, p in params.named_parameters()}

    return zeros() if mesh is None else [zeros() for _ in mesh.data.local]


def make_compressed_train_step(cfg, mesh, opt_cfg: AdamWConfig | None = None, *,
                               axis: str = "data"):
    """The data-parallel step with the EF-int8 reduction, the reference's
    shard_map over the data axis run for each local shard:
    ``fn(params, opt_state, residuals, batch) -> (params, opt_state,
    residuals, metrics)``.  Each shard takes its rows of the batch (which
    must divide the axis), computes its loss and gradients, the loss is
    averaged, the gradients go through :func:`tree_compress_psum`, and
    AdamW runs once on the mean, in place, the same in every process.
    ``residuals`` is :func:`init_residuals` ``(params, mesh)``."""
    if axis != "data":
        raise ValueError(f"axis={axis!r}: the port's data axis is 'data'")
    opt_cfg = opt_cfg or AdamWConfig()
    dm = mesh.data

    def fn(params, opt_state, residuals, batch):
        if len(residuals) != len(dm.local):
            raise ValueError(f"{len(residuals)} residual dicts for {len(dm.local)} local "
                             "shards: init_residuals(params, mesh)")
        losses, grads = shard_losses_and_grads(params, batch_to_device(batch, mesh.device),
                                               mesh, cfg=cfg)
        loss = _pmean(dm, losses)
        mean, residuals = tree_compress_psum(grads, residuals, dm)
        del grads
        params, opt_state, metrics = adamw_update(opt_cfg, params, mean, opt_state)
        metrics["loss"] = loss
        return params, opt_state, residuals, metrics

    return fn
