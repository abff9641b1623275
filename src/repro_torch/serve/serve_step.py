"""kNN-LM retrieval through the ``repro_torch.index`` facade (the port of
``repro.serve.serve_step``'s :class:`RetrievalStep` and
``make_retrieval_step``).

The datastore backend (flat on the card, streaming for online growth,
or any registered algorithm) is an IndexConfig field, not a code path.
Results carry an explicit validity mask — padded (-1) slots never alias
row 0's payload, and padded distance slots are neutralized to the
large-but-finite ``PAD_DISTANCE`` sentinel: weight ~0 under an
exp(-d)/softmax(-d) blend (like the facade's raw +inf padding) without
the NaN hazard +inf carries in 0·d expressions.

`RetrievalStep` is the per-call building block; ragged production
traffic (variable batch sizes, mixed k, bursts, interleaved inserts)
goes through ``repro_torch.serve.RequestScheduler``, which sits ON TOP
of a RetrievalStep: it buckets requests into a fixed palette of padded
(B, k) shapes, flushes by deadline-aware continuous batching, caches
repeated queries on their SQ8 codes, and sheds or degrades load under
backpressure.

The model steps ``make_prefill`` (fills the KV cache) and
``make_decode_step`` (one token against it) return ``(fn, info)`` as the
reference's do.  The port runs eagerly on one device, so ``fn`` is a
plain function under ``torch.inference_mode()`` and ``info`` carries the
shapes where the reference carries shardings; the decode step writes
the cache in place, the counterpart of the reference's donated cache.
Meshes with a 'model' axis past one device come with ROADMAP A12d.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import InputShape, input_specs
from ..index import IndexConfig, build_index
from ..launch.mesh import make_host_mesh
from ..models import model_module
from .batcher import PAD_DISTANCE

__all__ = ["RetrievalStep", "make_decode_step", "make_prefill", "make_retrieval_step"]


class RetrievalStep:
    """Batched kNN-LM retrieval over a (hidden-state → payload) datastore.

    Calling the step runs one facade search and gathers payloads:

        payloads, valid, distances, res = step(queries)

    ``payloads`` is ``values[indices]`` with padded slots gathered from
    row 0 as a placeholder; ``valid`` is the (B, k) bool mask that says
    which slots are real — callers MUST mask on it (a backend that
    returns fewer than k hits pads indices with -1, and the padding
    must not leak row 0's payload into the blend).

    When the backend is "stream"-capable (``backend="streaming"``), the
    datastore grows online: ``step.extend(new_keys, new_values)``
    inserts rows into the live index and appends the matching payloads,
    and ``step.evict(ids)`` tombstones stale entries — no rebuild, no
    serving pause.  Payloads are addressed by the index's global ids,
    which are append-order and never recycled, so the value store is a
    plain append-only host array.

    Flat datastores (``flat``, ``flat-pq``, streaming with flat
    segments) on the card serve lookups through the fused
    estimate → select → verify kernels by default; ``options={"fused":
    False}`` opts a datastore out, ``options={"use_kernels": False}``
    runs the kernels' plain PyTorch versions.

    Quantized datastores: pass the quant options through
    ``index_config`` (e.g. ``IndexConfig(backend="flat-pq")`` or
    ``options={"quant": "sq8", "store_raw": False}``) and the KEY side
    of the datastore is stored as codes.  ``key_bytes_per_point``
    reports the distance-storage footprint per key;
    ``key_raw_bytes_per_point`` the float32 rows retained for exact
    verify (0 with ``store_raw=False``).  Payload gathering is
    unchanged: codes only ever approximate distances, never values.

    ``device`` is where the index lives: the card by default, raising
    where CUDA is absent; ``"cpu"`` runs the plain PyTorch versions.
    """

    def __init__(self, keys, values, *, k: int = 8,
                 index_config: IndexConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.k = int(k)
        values = np.asarray(values)
        # payload store: geometrically-grown capacity buffer, so
        # repeated small ``extend`` calls are amortized O(1) instead of
        # one O(n) concatenate per call
        self._values_buf = values
        self._n_values = len(values)
        self._value_reallocs = 0
        #: datastore generation — bumped by every extend/evict, so
        #: result caches keyed on this step (serve.cache) can
        #: invalidate stale entries
        self.version = 0
        keys = np.asarray(keys, dtype=np.float32)
        if self._n_values != len(keys):
            raise ValueError(
                f"{len(keys)} keys for {self._n_values} payloads")
        self.index = build_index(keys,
                                 index_config or IndexConfig(backend="flat"),
                                 device=device)

    @property
    def values(self):
        """The live payload rows (a view of the capacity buffer)."""
        return self._values_buf[: self._n_values]

    @values.setter
    def values(self, new_values):
        self._values_buf = np.asarray(new_values)
        self._n_values = len(self._values_buf)

    @property
    def streaming(self) -> bool:
        return "stream" in getattr(self.index, "capabilities", frozenset())

    @property
    def key_bytes_per_point(self) -> float:
        """Distance-storage bytes per datastore key (quantization-aware:
        codes + amortized codebooks for quantized backends).  Raw
        float32 rows kept for exact verify are NOT included — see
        ``key_raw_bytes_per_point`` for the full resident picture."""
        fn = getattr(self.index, "bytes_per_point", None)
        return float(fn()) if fn else 4.0 * self.index.d

    @property
    def key_raw_bytes_per_point(self) -> float:
        """Full-precision bytes per key retained for exact verification
        (0 on codes-only datastores, ``store_raw=False``)."""
        fn = getattr(self.index, "raw_bytes_per_point", None)
        return float(fn()) if fn else 4.0 * self.index.d

    def __call__(self, queries):
        res = self.index.search(queries, k=self.k)
        valid = res.indices >= 0
        payload = self.values[np.where(valid, res.indices, 0)]
        # invalid slots gather row 0's payload as a placeholder AND get
        # their distance set to PAD_DISTANCE (large finite): under an
        # exp(-d)/softmax(-d) blend that slot's weight is ~0 — the same
        # masking the facade's raw +inf gives — but without +inf's NaN
        # hazard in 0·d expressions.  NOT inert under arbitrary blends:
        # callers must still mask on `valid`.
        distances = np.where(valid, res.distances, PAD_DISTANCE).astype(
            np.float32)
        return payload, valid, distances, res

    def extend(self, new_keys, new_values):
        """Insert (key → payload) rows into a streaming datastore;
        returns the new global ids.  New rows are retrievable at once."""
        if not self.streaming:
            raise NotImplementedError(
                f"backend {self.index.backend_name!r} is build-once; use "
                "IndexConfig(backend='streaming') for an online datastore")
        new_values = np.asarray(new_values)
        new_keys = np.asarray(new_keys, dtype=np.float32).reshape(
            -1, self.index.d)
        if len(new_values) != len(new_keys):
            raise ValueError(
                f"{len(new_keys)} keys for {len(new_values)} payloads")
        ids = self.index.insert(new_keys)
        need = self._n_values + len(new_values)
        dtype = np.result_type(self._values_buf, new_values)
        if dtype != self._values_buf.dtype:  # promote (concat semantics)
            self._values_buf = self._values_buf.astype(dtype)
            self._value_reallocs += 1
        if need > len(self._values_buf):  # geometric growth: amortized O(1)
            cap = max(need, 2 * len(self._values_buf), 16)
            buf = np.empty((cap,) + self._values_buf.shape[1:],
                           dtype=self._values_buf.dtype)
            buf[: self._n_values] = self._values_buf[: self._n_values]
            self._values_buf = buf
            self._value_reallocs += 1
        self._values_buf[self._n_values:need] = new_values
        self._n_values = need
        self.version += 1
        return ids

    def evict(self, ids) -> int:
        """Tombstone datastore entries (streaming backends only)."""
        if not self.streaming:
            raise NotImplementedError(
                f"backend {self.index.backend_name!r} is build-once")
        self.version += 1
        return self.index.delete(ids)


def make_retrieval_step(keys, values, *, k: int = 8,
                        index_config: IndexConfig | None = None,
                        device: str | torch.device = "cuda"):
    """Build a :class:`RetrievalStep` over ``keys`` (n, d) / ``values``
    on ``device``.

    Returns ``(step, step.index)``; ``step(queries)`` yields
    ``(payloads (B, k), valid (B, k) bool, distances (B, k),
    SearchResult)``.  Swap backends — flat, pmtree, streaming, any
    registered baseline — via ``index_config`` without touching the
    serving loop; with ``backend="streaming"`` the datastore accepts
    ``step.extend`` / ``step.evict`` while queries run.
    """
    step = RetrievalStep(keys, values, k=k, index_config=index_config,
                         device=device)
    return step, step.index


def _shapes(tensors) -> object:
    """The shapes of a tree of (meta) tensors: dicts, lists, modules."""
    if isinstance(tensors, torch.nn.Module):
        return {name: tuple(t.shape) for name, t in tensors.named_parameters()}
    if isinstance(tensors, dict):
        return {name: _shapes(t) for name, t in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return [_shapes(t) for t in tensors]
    return tuple(tensors.shape)


def _check_tokens(batch_in: dict, want: tuple, what: str) -> None:
    got = tuple(batch_in["tokens"].shape)
    if got != want:
        raise ValueError(f"{what} was built for tokens {want}, got {got}")


def _step_info(cfg, mod, b_specs, c_specs) -> dict:
    aparams = mod.abstract_params(cfg)
    return {"params": _shapes(aparams), "batch": _shapes(b_specs),
            "cache": _shapes(c_specs), "abstract_params": aparams,
            "cache_specs": c_specs, "batch_specs": b_specs}


def make_prefill(cfg, mesh=None, *, batch: int, seq_len: int, max_seq: int | None = None):
    """``fn(params, batch_in) -> (last logits (B, 1, Vp), caches)``: a
    forward over the prompt that fills fresh KV caches of ``max_seq``
    rows on the mesh's device (the card unless the mesh names the CPU)."""
    mesh = make_host_mesh() if mesh is None else mesh
    mod = model_module(cfg)
    max_seq = max_seq or seq_len
    c_specs = mod.cache_specs(cfg, batch, max_seq)
    b_specs = input_specs(cfg, InputShape("prefill", seq_len, batch, "prefill"))

    @torch.inference_mode()
    def fn(params, batch_in):
        _check_tokens(batch_in, (batch, seq_len), "make_prefill")
        caches = mod.init_cache(cfg, batch, max_seq, device=mesh.device)
        return mod.forward(params, batch_in["tokens"], cfg, caches=caches, position0=0,
                           memory=batch_in.get("image_embeds"), logits_slice="last")

    return fn, _step_info(cfg, mod, b_specs, c_specs)


def make_decode_step(cfg, mesh=None, *, batch: int, max_seq: int):
    """``fn(params, caches, batch_in) -> (logits (B, 1, Vp), caches)``: one
    token per sequence at ``batch_in["position"]`` (an int or a 0-d
    tensor), the caches written in place."""
    mesh = make_host_mesh() if mesh is None else mesh
    mod = model_module(cfg)
    c_specs = mod.cache_specs(cfg, batch, max_seq)
    b_specs = input_specs(cfg, InputShape("decode", max_seq, batch, "decode"))

    @torch.inference_mode()
    def fn(params, caches, batch_in):
        _check_tokens(batch_in, (batch, 1), "make_decode_step")
        return mod.decode_step(params, caches, batch_in, cfg)

    return fn, _step_info(cfg, mod, b_specs, c_specs)
