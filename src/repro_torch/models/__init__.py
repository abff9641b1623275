"""The decoder LM and its building blocks, the port of ``repro.models``:
``layers`` (norms, RoPE, chunked attention, GQA and cross attention,
MLPs), ``flash_attention`` (its forward), ``lsh_attention`` (PM-LSH
decode attention), ``moe`` and ``transformer`` (the dense, moe and vlm
families).  The recurrent blocks and whisper's encoder-decoder come
with ROADMAP A12b."""
from . import flash_attention, layers, lsh_attention, moe, transformer  # noqa: F401


def model_module(cfg):
    """Dispatch: which module implements this config's family."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name} (encdec): whisper's encoder-decoder is not ported yet; "
            "it comes with ROADMAP A12b")
    return transformer
