"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

kernels (sources in ``csrc/``, built by ``_build`` at first use):
  pairwise_dist — ESTIMATE and the unfused VERIFY: pairwise squared
                  distances, (B, d) × (N, d) and per-query (B, N, d)
  select        — radius-threshold SELECT: rung ladder + bisection +
                  index-ordered compaction of the T = βn + k budget
  verify        — gather-free VERIFY: exact distances on candidate ids
                  and a streaming top-k answer
  adc           — the quantized RERANK: asymmetric distances from uint8
                  codes and per-query tables
  pair_join     — closest pair: the band-major pruned self-join
  topk          — row-wise k ≤ 128 smallest: the streaming index's
                  delta scan and fan-out merge
  project_dist  — the fused projection + projected distances (x @ A
                  never written out)
ops    — dispatch: CUDA tensors launch the kernels, CPU tensors take the
         plain versions
ref    — the plain PyTorch versions (the semantics contract)
merge  — the sharded query's all-gather-of-k merge (a torch function,
         as the reference's is jnp)
counts — launch counts of every kernel
"""
from . import counts, ops, ref  # noqa: F401
