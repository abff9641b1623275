"""deepseek-67b [arXiv:2401.02954]: llama-arch dense, 95L d=8192 64H
(GQA kv=8) d_ff=22016 vocab=102400."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    lsh_topk=32,
    lsh_m=8,
)
