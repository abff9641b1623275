"""whisper-base [arXiv:2212.04356]: enc-dec, 6+6L d=512 8H d_ff=2048
vocab 51865 (padded to 52224 for clean model-axis sharding); conv/mel
frontend is a STUB — input_specs() provides 1500 precomputed frame
embeddings.  Short audio contexts: implemented WITHOUT LSH attention
(DESIGN.md §Arch-applicability)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    n_audio_frames=1500,
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    n_audio_frames=32,
)
