"""The LMs and their building blocks, the port of ``repro.models``:
``layers`` (norms, RoPE, chunked attention, GQA and cross attention,
MLPs), ``flash_attention`` (its forward and backward), ``lsh_attention`` (PM-LSH
decode attention), ``moe``, ``scan`` (the linear-recurrence scan),
``recurrent`` (RG-LRU), ``xlstm`` (mLSTM, sLSTM), ``transformer`` (the
dense, moe, vlm, hybrid and ssm families) and ``whisper`` (the
encoder-decoder)."""
from . import (  # noqa: F401
    flash_attention,
    layers,
    lsh_attention,
    moe,
    recurrent,
    scan,
    transformer,
    whisper,
    xlstm,
)


def model_module(cfg):
    """Dispatch: which module implements this config's family."""
    if cfg.family == "encdec":
        return whisper
    return transformer
