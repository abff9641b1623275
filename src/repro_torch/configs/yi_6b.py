"""yi-6b [arXiv:2403.04652]: llama-arch dense GQA, 32L d=4096 32H (kv=4)
d_ff=11008 vocab=64000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="yi-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    lsh_topk=32,
    lsh_m=8,
)
