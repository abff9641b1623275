"""xlstm-125m [arXiv:2405.04517]: sLSTM + mLSTM blocks, 12L d=768 4H,
vocab 50304, no separate FFN (d_ff=0 — the blocks carry their own
projections).  Attention-free: the paper's LSH technique does not apply
to its sequence mixing (DESIGN.md §Arch-applicability); long_500k runs
natively on the recurrent state."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
)

SMOKE_CONFIG = CONFIG.replace(
    name="xlstm-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    vocab_size=256,
)
