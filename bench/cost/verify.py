"""VERIFY: exact squared distances of each query to its T candidates and
the k nearest of them, from the rows (n, d) float32.

Each distinct candidate row of the batch read once (``rows``, counted
from the reference's candidate sets), the (B, T) candidate ids and the
queries read once, the (B, k) answer (distance and id) written once; one
multiply-add a dimension of each (query, candidate) pair.  The topk
launch that verify makes to rank its distances is verify's."""
KERNELS = (r"\bverify_entries_kernel\b", r"\bverify_tile_sum_kernel\b",
           r"\bverify_tile_scan_kernel\b", r"\bverify_tile_write_kernel\b",
           r"\bverify_dist_kernel\b", r"\bverify_wide_kernel\b", r"\btopk_kernel\b")


def cost(B: int, T: int, d: int, k: int, rows: int) -> tuple[int, int]:
    """(bytes, FLOPs)."""
    return 4 * (rows * d + B * T + B * d + 2 * B * k), 2 * B * T * d
