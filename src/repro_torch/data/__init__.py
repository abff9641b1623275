"""repro_torch.data — data-pipeline stages (the port of ``repro.data``).

``dedup``: near-duplicate detection for training corpora through the
c-ACP query (``core.cp.PMLSH_CP``); ``pipeline``: deterministic
synthetic token batches and their host prefetch, for the trainer.
"""
from .dedup import dedup_mask, embed_docs, find_near_duplicates  # noqa: F401
from .pipeline import Prefetcher, SyntheticTokens  # noqa: F401

__all__ = ["embed_docs", "find_near_duplicates", "dedup_mask", "SyntheticTokens", "Prefetcher"]
