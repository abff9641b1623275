"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision]: 40L d=4096
32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention image layers
every 5th layer.  The vision frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, n_image_tokens, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1601,  # one 448px tile → 1601 patch tokens
    rope_theta=5e5,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama32-vision-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=2,
    n_image_tokens=17,
    lsh_topk=32,
    lsh_m=8,
)
