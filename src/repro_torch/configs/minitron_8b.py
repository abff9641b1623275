"""minitron-8b [arXiv:2407.14679]: pruned nemotron dense, 32L d=4096 32H
(GQA kv=8) d_ff=16384 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="minitron-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    lsh_topk=32,
    lsh_m=8,
)
