"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H (kv=16)
MoE 60 routed experts top-4 + 4 shared, expert d_ff=1408, vocab 151936.

60 experts are padded to 64 (multiple of the 16-wide model axis); the
padding experts receive -inf router logits (configs/base + moe.py)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    n_experts_per_token=4,
    n_shared_experts=4,
    lsh_attention=True,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    n_experts=6,
    n_experts_per_token=2,
    n_shared_experts=1,
    lsh_topk=32,
    lsh_m=8,
    capacity_factor=8.0,  # dropless at smoke scale (see qwen3 smoke note)
)
