"""repro_torch.data — data-pipeline stages (the port of ``repro.data``).

``dedup``: near-duplicate detection for training corpora through the
c-ACP query (``core.cp.PMLSH_CP``).  The reference's ``pipeline``
(token batches for the trainer) comes with training (ROADMAP A12c).
"""
from .dedup import dedup_mask, embed_docs, find_near_duplicates  # noqa: F401

__all__ = ["embed_docs", "find_near_duplicates", "dedup_mask"]
