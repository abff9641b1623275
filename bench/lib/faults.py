"""Faults planted in a cell's timed path, to read what its check makes of
them: the CPU tests plant them at tiny sizes, ``bench/readings.py
--fault <name>`` at the cell's own size on the card.  Each takes the kind
after its set-up and breaks the entry its window drives."""
from __future__ import annotations

__all__ = ["FAULTS", "cp_half_rows"]


def cp_half_rows(kind) -> None:
    """The closest-pair search joins half of the rows and leaves the rest
    out: the program's own index over the first half of the collection,
    with the same projection and parameters, answers every call."""
    from repro_torch.index import FlatBackend, IndexConfig

    half = kind.rows[: kind.n // 2]
    cfg = IndexConfig(backend="flat", cp_c=kind.cp_c, m=kind.m)
    index = FlatBackend.from_arrays(half, kind.a.cpu().numpy(), config=cfg,
                                    device=kind.device)
    for k in kind.choices:  # its kernels' shapes warm, as set-up warms the cell's
        index.cp_search(k)
    kind.cp = index.cp_search


FAULTS = {"cp_half_rows": cp_half_rows}
