"""Carry a JAX index across to the port.

The JAX package draws the projection A with ``jax.random.normal``,
which torch cannot reproduce, so a port index that must answer what a
JAX index answers takes that index's arrays as numpy:

    ji = repro.index.build_index(data, IndexConfig(backend="flat"))
    ti = repro_torch.index.FlatBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected))

A quantized index also carries its codec and codes across: PQ encoding
is an argmin whose near-ties can fall either way between XLA's and
torch's summation orders, so a port index that must answer what a JAX
``flat-pq`` index answers takes the JAX codes too:

    codec = codec_from_arrays(centroids=np.asarray(ji.codec.centroids),
                              d=ji.codec.d)
    ti = repro_torch.index.FlatPQBackend.from_arrays(
        data, a, projected, config, codec=codec, codes=np.asarray(ji.codes))

A PM-tree index is carried the same way, and with the JAX index's
``projected`` it builds the JAX index's trees:

    ji = repro.index.build_index(data, IndexConfig(backend="pmtree"))
    ti = repro_torch.index.PMTreeBackend.from_arrays(
        data, np.asarray(ji.impl.family.a), np.asarray(ji.impl.projected))

The bucket baselines (Multi-Probe, LSB-tree) take their JAX families'
arrays through :func:`bucket_families_from_arrays`, and SRS / R-LSH take
``a`` and ``projected`` as options:

    fams = bucket_families_from_arrays(
        [(np.asarray(f.a), np.asarray(f.b), f.w) for f, _ in jax_mp.tables])
    ti = build_index(data, IndexConfig(backend="multiprobe",
                                       options={"families": fams}))

An LM's parameters come across whole.  The reference keeps a decoder
LM's as a pytree of stacked ``unit`` leaves (a leading n_units
dimension) plus the ``rest`` blocks, and whisper's encoder and decoder
layers stacked; :func:`lm_params_from_numpy` unstacks them into the
port's one module a layer, in the reference's layer order:

    tree = jax.tree.map(np.asarray, repro.models.model_module(cfg).init_params(cfg, key))
    params = lm_params_from_numpy(cfg, tree, device="cpu")

JAX's bfloat16 arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays,
which ``torch.from_numpy`` refuses: :func:`tensor_from_numpy` views them
as int16 and reinterprets the bits as ``torch.bfloat16``, bit for bit.

The way back restacks the port's tensors into the reference's tree:
:func:`lm_params_to_tree` (one host copy a leaf, dtypes kept; what a
checkpoint stores) and :func:`lm_params_to_numpy` (numpy, bfloat16 widened to
float32 exactly, as numpy has no bfloat16).  Either takes the model or
a mapping keyed like its ``named_parameters()`` — its gradients, or the
optimizer's moments — so a test can hold the port's gradients against
``jax.grad``'s leaf by leaf.  :func:`opt_state_to_numpy` and
:func:`opt_state_from_numpy` carry AdamW's state across the same way.

This module imports nothing of JAX; the caller hands over numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.estimator import solve_parameters
from .core.flat_index import FlatIndex
from .core.hashing import BucketFamily, ProjectionFamily
from .device import as_tensor, resolve_device
from .models import model_module, whisper
from .models.layers import Params
from .models.transformer import DecoderLM, abstract_params, layer_plan
from .quant.codec import PQCodec, SQ8Codec

__all__ = ["flat_index_from_arrays", "codec_from_arrays", "bucket_families_from_arrays",
           "lm_params_from_numpy", "tensor_from_numpy", "lm_params_to_tree",
           "lm_params_to_numpy", "opt_state_to_numpy", "opt_state_from_numpy"]


def flat_index_from_arrays(data: np.ndarray | torch.Tensor, a: np.ndarray,
                           projected: np.ndarray | None = None, *,
                           c: float = 1.5, m: int | None = None,
                           device: str | torch.device = "cuda") -> FlatIndex:
    """A :class:`FlatIndex` over ``data`` (n, d) with projection ``a``
    (d, m); ``projected`` (n, m) is taken as given when passed (the JAX
    index's own ``data @ a``), else computed here.  A ``data`` tensor
    already on ``device`` is used without a copy."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        data_t = data.to(device=dev, dtype=torch.float32).contiguous()
    else:
        data_t = as_tensor(data, dev)
    family = ProjectionFamily.from_numpy(a, dev)
    if family.d != data_t.shape[1]:
        raise ValueError(f"a is ({family.d}, {family.m}) for data of d={data_t.shape[1]}")
    if m is not None and m != family.m:
        raise ValueError(f"m={m} but a has {family.m} columns")
    if projected is None:
        proj = family.project(data_t)
    else:
        proj = as_tensor(projected, dev)
        if tuple(proj.shape) != (data_t.shape[0], family.m):
            raise ValueError(f"projected {tuple(proj.shape)} for data "
                             f"{tuple(data_t.shape)} and m={family.m}")
    return FlatIndex(data=data_t, projected=proj, family=family,
                     params=solve_parameters(c, m=family.m))


def codec_from_arrays(*, scale: np.ndarray | None = None,
                      offset: np.ndarray | None = None,
                      centroids: np.ndarray | None = None, d: int | None = None,
                      device: str | torch.device = "cuda") -> SQ8Codec | PQCodec:
    """The port's codec from a JAX codec's arrays: ``centroids`` (S, V,
    ds) and ``d`` for PQ, or ``scale`` and ``offset`` (d,) for SQ8."""
    dev = resolve_device(device)
    if centroids is not None:
        cents = as_tensor(centroids, dev)
        if cents.ndim != 3 or d is None or not 1 <= d <= cents.shape[0] * cents.shape[2]:
            raise ValueError(f"PQ needs centroids (S, V, ds) and d ≤ S·ds, got "
                             f"{tuple(cents.shape)} and d={d}")
        return PQCodec(centroids=cents, d=int(d))
    if scale is None or offset is None:
        raise ValueError("codec_from_arrays needs centroids and d (PQ) or "
                         "scale and offset (SQ8)")
    scale_t, offset_t = as_tensor(scale, dev), as_tensor(offset, dev)
    if scale_t.ndim != 1 or scale_t.shape != offset_t.shape:
        raise ValueError(f"SQ8 needs scale and offset of one shape (d,), got "
                         f"{tuple(scale_t.shape)} and {tuple(offset_t.shape)}")
    return SQ8Codec(scale=scale_t, offset=offset_t)


def bucket_families_from_arrays(families, *, device: str | torch.device = "cuda"
                                ) -> list[BucketFamily]:
    """The port's bucket families from (a (d, m), b (m,), w) triples,
    e.g. a JAX Multi-Probe index's tables' or an LSB-tree's trees'."""
    dev = resolve_device(device)
    return [BucketFamily.from_numpy(a, b, w, dev) for a, b, w in families]


def tensor_from_numpy(array, device: str | torch.device = "cuda") -> torch.Tensor:
    """A tensor on ``device`` holding ``array``'s values in its own dtype;
    a bfloat16 array (``ml_dtypes``) is carried across bit for bit.  A
    tensor is copied to ``device`` as it is."""
    dev = resolve_device(device)
    if isinstance(array, torch.Tensor):
        return array.detach().to(dev, copy=True).contiguous()
    a = np.ascontiguousarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def lm_params_from_numpy(cfg, tree: dict, device: str | torch.device = "cuda"):
    """The port's LM from the reference's parameter pytree as numpy arrays.

    A decoder LM (:class:`~repro_torch.models.transformer.DecoderLM`, every
    family but encdec) comes from ``embed``, ``unit`` — a tuple of stacked
    block trees, one per position of the layer plan's unit —, ``rest``,
    ``final_norm`` and ``lm_head`` unless the embeddings are tied; the
    encoder-decoder (:class:`~repro_torch.models.whisper.EncDecLM`) from
    ``embed``, the stacked ``encoder`` and ``decoder`` trees, ``enc_norm``,
    ``final_norm`` and ``lm_head``.  Stacked trees are unstacked into one
    module a layer, in the reference's layer order.  Shapes and dtypes
    are checked against the port's own layout."""
    dev = resolve_device(device)

    def module(node, take=None):
        if isinstance(node, dict):
            return Params(**{name: module(v, take) for name, v in node.items()})
        a = node if isinstance(node, torch.Tensor) else np.asarray(node)
        return tensor_from_numpy(a if take is None else a[take], dev)

    def leaves(node):
        return [x for v in node.values() for x in leaves(v)] if isinstance(node, dict) else [node]

    def tensor(name):
        return tensor_from_numpy(tree[name], dev)

    if cfg.family == "encdec":
        stacked = {name: {np.shape(x)[0] for x in leaves(tree[name])}
                   for name in ("encoder", "decoder")}
        want_n = {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers}
        if any(stacked[name] != {want_n[name]} for name in stacked):
            raise ValueError(f"encoder and decoder trees stacked {stacked} for "
                             f"{cfg.encoder_layers} + {cfg.n_layers} layers")
        params = whisper.EncDecLM(
            cfg, [module(tree["encoder"], u) for u in range(cfg.encoder_layers)],
            [module(tree["decoder"], u) for u in range(cfg.n_layers)], tensor("embed"),
            tensor("enc_norm"), tensor("final_norm"), tensor("lm_head"))
        want = whisper.abstract_params(cfg)
    else:
        unit, n_units, rest = layer_plan(cfg)
        stacked = {np.shape(x)[0] for block in tree["unit"] for x in leaves(block)}
        if (len(tree["unit"]) != (len(unit) if n_units else 0)
                or len(tree["rest"]) != len(rest) or stacked - {n_units}):
            raise ValueError(f"a tree of {len(tree['unit'])} unit blocks stacked "
                             f"{sorted(stacked)} and {len(tree['rest'])} rest blocks for "
                             f"the plan {unit} × {n_units} + {rest}")
        blocks = [module(tree["unit"][i], u) for u in range(n_units) for i in range(len(unit))]
        blocks += [module(b) for b in tree["rest"]]
        head = tree.get("lm_head")
        params = DecoderLM(cfg, blocks, tensor("embed"), tensor("final_norm"),
                           None if head is None else tensor_from_numpy(head, dev))
        want = abstract_params(cfg)

    def layout(m):
        return {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}

    want, got = layout(want), layout(params)
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise ValueError(f"the tree does not fit {cfg.name}'s layout: {diff}")
    return params


def _nest(named: dict, prefix: str) -> dict:
    """{"attn.wq": t, …} under ``prefix`` → {"attn": {"wq": t}, …}."""
    out: dict = {}
    for name, t in named.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
    return out


def _host(t: torch.Tensor) -> torch.Tensor:
    """One copy of ``t`` in host memory; a meta tensor stays meta."""
    return t if t.is_meta else t.to("cpu", copy=True)


def _stack(layers: list[dict]) -> dict:
    """Layer trees of one structure → one tree of leaves stacked on a new
    leading axis (the reference's scanned layout), in host memory: each
    layer's leaf is copied once, straight into its slice."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    out = torch.empty((len(layers), *first.shape), dtype=first.dtype,
                      device="meta" if first.is_meta else "cpu")
    if not first.is_meta:
        for row, t in zip(out, layers):
            row.copy_(t)
    return out


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_tree_map(fn, v) for v in node)
    return fn(node)


def lm_params_to_tree(cfg, params) -> dict:
    """The reference's parameter tree from the port's LM (or a mapping
    keyed by its parameter names), in the tensors' own dtypes:
    ``lm_params_from_numpy``'s inverse.  Each leaf is copied once into
    host memory, so the tree is the caller's to keep; meta tensors (the
    abstract parameters) give a meta tree, a structure with no data.  A
    decoder's layers are restacked into ``unit`` (a tuple, one tree a
    position of the layer plan's unit, stacked over the units) and
    ``rest``; the encoder-decoder's into stacked ``encoder`` and
    ``decoder`` trees.  An absent ``lm_head`` (tied embeddings) is absent
    here too."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    named = {name: t.detach() for name, t in items}
    top = {name: _host(t) for name, t in named.items() if "." not in name}
    if cfg.family == "encdec":
        return {**top, "encoder": _stack([_nest(named, f"encoder.{i}.")
                                          for i in range(cfg.encoder_layers)]),
                "decoder": _stack([_nest(named, f"decoder.{i}.") for i in range(cfg.n_layers)])}
    unit, n_units, rest = layer_plan(cfg)
    blocks = [_nest(named, f"blocks.{i}.") for i in range(cfg.n_layers)]
    stacked = tuple(_stack([blocks[u * len(unit) + j] for u in range(n_units)])
                    for j in range(len(unit))) if n_units else ()
    return {**top, "unit": stacked,
            "rest": tuple(_tree_map(_host, b) for b in blocks[n_units * len(unit):])}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(cfg, params) -> dict:
    """:func:`lm_params_to_tree` as numpy arrays; bfloat16 leaves come out
    as float32 (exact: numpy has no bfloat16)."""
    return _tree_map(_numpy, lm_params_to_tree(cfg, params))


def opt_state_to_numpy(cfg, opt_state: dict) -> dict:
    """AdamW's state ({"mu", "nu"} keyed by parameter name, "step") as the
    reference's: ``mu`` and ``nu`` restacked into its parameter tree,
    ``step`` a 0-d int32 array."""
    return {"mu": lm_params_to_numpy(cfg, opt_state["mu"]),
            "nu": lm_params_to_numpy(cfg, opt_state["nu"]),
            "step": np.asarray(opt_state["step"].cpu(), dtype=np.int32)}


def _flat(node, prefix: str, take=None) -> dict:
    if isinstance(node, dict):
        return {n: t for k, v in node.items() for n, t in _flat(v, f"{prefix}{k}.", take).items()}
    return {prefix[:-1]: node if take is None else node[take]}


def _unstack(cfg, tree: dict) -> dict:
    """The reference's stacked tree → {parameter name: leaf}, the port's
    names (``lm_params_to_tree``'s inverse, leaves left as they are)."""
    top = {k: v for k, v in tree.items() if k not in ("unit", "rest", "encoder", "decoder")}
    named = _flat(top, "")
    if cfg.family == "encdec":
        for part, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.n_layers)):
            for i in range(n):
                named.update(_flat(tree[part], f"{part}.{i}.", i))
        return named
    unit, n_units, _ = layer_plan(cfg)
    for j, block in enumerate(tree["unit"]):
        for u in range(n_units):
            named.update(_flat(block, f"blocks.{u * len(unit) + j}.", u))
    for i, block in enumerate(tree["rest"]):
        named.update(_flat(block, f"blocks.{n_units * len(unit) + i}."))
    return named


def opt_state_from_numpy(cfg, tree: dict, device: str | torch.device = "cuda") -> dict:
    """The reference's AdamW state (numpy or tensor leaves) as the port's
    on ``device``: ``mu`` and ``nu`` keyed by the parameter names of
    ``cfg``'s layout, float32; ``step`` a 0-d int32 tensor."""
    dev = resolve_device(device)
    want = {n: tuple(p.shape) for n, p in model_module(cfg).abstract_params(cfg).named_parameters()}

    def moments(part):
        try:
            leaves = _unstack(cfg, tree[part])
        except (IndexError, KeyError, TypeError) as e:  # another plan's tree
            raise ValueError(f"the optimizer's {part} does not fit {cfg.name}'s layout: "
                             f"{e!r}") from e
        got = {n: tuple(np.shape(a)) for n, a in leaves.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:6]
            raise ValueError(f"the optimizer's {part} does not fit {cfg.name}'s layout: {diff}")
        return {n: tensor_from_numpy(a, dev).float() for n, a in leaves.items()}

    step = tensor_from_numpy(tree["step"], dev)
    return {"mu": moments("mu"), "nu": moments("nu"),
            "step": step.to(torch.int32).reshape(())}

