"""recurrentgemma-9b [arXiv:2402.19427]: hybrid RG-LRU + local attention,
pattern (rec, rec, local-attn), 38L d=4096 16H (kv=1 MQA) d_ff=12288
vocab=256000, window 2048.  Natively sub-quadratic: long_500k runs with
the recurrence + sliding window (no LSH attention needed)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 12×(rec,rec,local) + (rec,rec) remainder
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local"),
    rnn_width=4096,
    conv1d_width=4,
    window=2048,
)

SMOKE_CONFIG = CONFIG.replace(
    name="recurrentgemma-smoke",
    n_layers=5,  # 1 unit + (rec, rec) remainder
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    rnn_width=64,
    window=32,
)
