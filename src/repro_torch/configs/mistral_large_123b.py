"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]:
dense, 88L d=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="mistral-large-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    lsh_topk=32,
    lsh_m=8,
)
