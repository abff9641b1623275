"""repro_torch — PM-LSH's flat index (ANN, closest pair, quantized
storage) and the streaming index over it, in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch counterpart of ``repro`` (the JAX package, which stays the
reference).  Layout mirrors it: ``core`` (estimator, projection family,
flat index, fused pipeline, closest-pair engine), ``kernels`` (CUDA
kernels, their plain PyTorch twins and the dispatch), ``quant`` (SQ8/PQ
codecs and the ADC rerank tier), ``index`` (the facade), ``stream`` (the
mutable streaming index), ``obs`` (span tracer with kernel spans on
the H100's roofline, metrics registry, exporters, quality auditor, drift
monitor), ``resilience`` (the streaming index's write-ahead log,
snapshots and ``recover``, fault injection, circuit breaker), ``serve``
(the request scheduler over a ``RetrievalStep``: continuous batching,
the SQ8 hot-query cache, admission, serve metrics) and ``data``
(near-duplicate detection through the closest-pair query).
``convert`` carries a JAX flat index's arrays across.

Entry points run on the card (``device="cuda"``) and raise where CUDA is
absent unless the caller asks for ``device="cpu"``.  This package
imports neither ``jax`` nor anything of ``repro``.
"""
from .device import resolve_device  # noqa: F401
