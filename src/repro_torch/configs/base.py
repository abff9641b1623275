"""Model configuration schema + registry + input specs, the port of
``repro.configs.base``.

Every assigned architecture is a `ModelConfig`; `input_specs()` produces
meta-device tensors (PyTorch's shape without allocation) for each
assigned input shape, where the reference produces ShapeDtypeStructs.
The fields, defaults, parameter counts and the registry are the
reference's; only ``dtype`` is a torch dtype.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

# ---------------------------------------------------------------------------
# config schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads

    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # routed-expert hidden size (if != d_ff)
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: tuple[str, ...] = ()
    rnn_width: int = 0  # RG-LRU recurrence width (0 → d_model)
    conv1d_width: int = 4
    window: int = 0  # sliding-window size for local attention (0 = full)

    # ssm (xlstm): pattern over ("mlstm","slstm")
    # vlm
    cross_attn_every: int = 0  # a cross-attn layer every N layers
    n_image_tokens: int = 0

    # encdec (whisper)
    encoder_layers: int = 0
    n_audio_frames: int = 0

    # PM-LSH retrieval attention (the paper's technique, in-graph)
    lsh_attention: bool = False  # enable for long-context decode
    lsh_m: int = 16  # projected dimensionality (paper: m=15; 16 is lane-friendly)
    lsh_topk: int = 2048  # candidate budget T per query head

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    # training
    max_seq_len: int = 4096
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode a 500k context? (natively, or via the
        paper's LSH retrieval attention)"""
        return self.family in ("ssm", "hybrid") or self.lsh_attention

    def padded_vocab(self, multiple: int = 512) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def padded_experts(self, multiple: int = 16) -> int:
        if self.n_experts == 0:
            return 0
        return ((self.n_experts + multiple - 1) // multiple) * multiple

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----------

    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = qkv + o
        dense_mlp = 3 * d * ff  # SwiGLU
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def moe_mlp() -> int:
            ffe = self.moe_d_ff or ff
            n_routed = (
                self.n_experts_per_token if active_only else self.n_experts
            )
            routed = n_routed * 3 * d * ffe
            shared = self.n_shared_experts * 3 * d * ffe
            router = d * self.n_experts
            return routed + shared + router

        if self.family == "moe":
            per_layer = attn + moe_mlp()
            return self.n_layers * per_layer + emb
        if self.family == "hybrid":
            rw = self.rnn_width or d
            # RG-LRU block: in/out proj + gates + conv
            rec = 2 * d * rw + 2 * rw * rw + rw * self.conv1d_width + rw * d
            n_rec = self.n_layers * self.block_pattern.count("rec") // max(
                len(self.block_pattern), 1
            )
            n_att = self.n_layers - n_rec
            return n_att * (attn + dense_mlp) + n_rec * (rec + dense_mlp) + emb
        if self.family == "ssm":
            # mLSTM/sLSTM blocks: qkv-ish projections + gates + ffn
            per_layer = 4 * d * d + dense_mlp
            return self.n_layers * per_layer + emb
        if self.family == "encdec":
            enc = self.encoder_layers * (attn + 2 * d * ff)  # GELU mlp (2 mats)
            dec = self.n_layers * (2 * attn + 2 * d * ff)  # self + cross
            return enc + dec + emb
        if self.family == "vlm":
            n_cross = (
                self.n_layers // self.cross_attn_every if self.cross_attn_every else 0
            )
            return (self.n_layers * (attn + dense_mlp)
                    + n_cross * (attn + dense_mlp) + emb)
        return self.n_layers * (attn + dense_mlp) + emb


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of this cell.

    train/prefill: full token batch (+ labels for train).
    decode: one new token per sequence + the position scalar; the KV
    cache is part of the serve state (see models.transformer.cache_specs).
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32 = torch.int32
    out: dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = meta((B, S), i32)
        out["labels"] = meta((B, S), i32)
    elif shape.kind == "prefill":
        out["tokens"] = meta((B, S), i32)
    else:  # decode: one token step against a length-S cache
        out["tokens"] = meta((B, 1), i32)
        out["position"] = meta((), i32)
    # modality frontends are STUBS: precomputed embeddings arrive as inputs
    if cfg.family == "vlm":
        out["image_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_model), cfg.dtype)
    if cfg.family == "encdec":
        out["audio_frames"] = meta((B, cfg.n_audio_frames, cfg.d_model), cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ARCHS = [
    "qwen3_moe_30b_a3b",
    "qwen2_moe_a2_7b",
    "deepseek_67b",
    "yi_6b",
    "mistral_large_123b",
    "minitron_8b",
    "llama32_vision_11b",
    "recurrentgemma_9b",
    "xlstm_125m",
    "whisper_base",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    key = _ALIASES.get(name, name).replace("-", "_")
    return importlib.import_module(f"{__package__}.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)
