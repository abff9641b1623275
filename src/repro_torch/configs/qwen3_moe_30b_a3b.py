"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4)
MoE 128 experts top-8, expert d_ff=768, vocab 151936."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # (MoE model: routed-expert hidden size)
    moe_d_ff=768,
    vocab_size=151936,
    n_experts=128,
    n_experts_per_token=8,
    rope_theta=1e6,
    lsh_attention=True,  # PM-LSH retrieval attention for long_500k decode
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    n_experts=8,
    n_experts_per_token=2,
    lsh_topk=32,
    lsh_m=8,
    # dropless at smoke scale: full-forward vs prefill+decode logits must
    # agree exactly (capacity dropping depends on the token count)
    capacity_factor=8.0,
)
