"""repro_torch.stream — the mutable streaming index behind the facade,
the port of ``repro.stream``.

An LSM-style layer over the port's static backends:

    delta buffer   — mutable tail on the card, served by an exact scan
                     (pairwise kernel, then the top-k kernel)
    segments       — sealed immutable runs, each a ``pmtree`` (the
                     default), ``flat`` or ``flat-pq`` index over its
                     points
    tombstones     — deletes are an id-set applied at merge time
    compaction     — threshold-triggered rebuild of small segments
                     into one larger segment (tombstones dropped)

``StreamingIndex`` satisfies the ``Index`` protocol plus ``insert`` /
``delete`` / ``flush`` and registers as backend ``"streaming"`` with
capabilities ``("ann", "stream", "cp")``.
"""
from .delta import DeltaBuffer  # noqa: F401
from .index import StreamingIndex  # noqa: F401
from .segment import Segment  # noqa: F401

__all__ = ["DeltaBuffer", "Segment", "StreamingIndex"]
